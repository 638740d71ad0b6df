"""Model container: a resident model instance = weights on the device + a
KV cache arena; port of ``repro.serving.container``.

This is the serving-side realisation of the paper's "container": its
memory footprint decides its KiSS size class and its instantiation cost
IS the cold start.  The reference's cold start is init plus ``jax.jit``
compilation; the port runs eagerly, so its cold start is the weights'
init on the device plus one warm-up prefill and decode (which also
builds the attention kernels on a process's first container).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..models import decode_step, init_params, prefill
from ..models.attention import cache_slots
from ..models.rwkv import _heads as rwkv_heads
from ..models.ssm import _dims as ssm_dims
from ..models.config import ModelConfig


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def pytree_mb(tree) -> float:
    """MB (1e6 bytes) of the tensors in a module or a nested
    dict/list/tuple of tensors."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree)) / 1e6


def cache_mb(cfg: ModelConfig, batch: int, max_len: int) -> float:
    """MB of an f32 cache arena for ``batch`` sequences of ``max_len``,
    from its shapes (the reference's
    ``pytree_mb(init_caches(..., dtype=f32))``), layer kind by layer kind:
    at each attention position k and v ``[B, S_c, KV, D]`` f32 and
    ``slot_pos`` i32 ``[B, S_c]``; at each Mamba layer the conv history
    ``[B, W-1, conv_dim]`` and the state ``[B, H, N, P]``; at each RWKV
    layer the two shifts ``[B, D]`` and the state ``[B, H, 64, 64]``; for
    an encoder-decoder also each decoder layer's cross k and v
    ``[B, S_enc, H, D]``; all f32.  An MoE layer is an attention
    position."""
    per_kind = {}
    if cfg.n_heads:
        s = cache_slots(cfg, max_len)
        per_kind["attn"] = (2 * batch * s * cfg.n_kv_heads
                            * cfg.resolved_head_dim + batch * s)
    if cfg.arch_type == "hybrid":
        _, nh, conv_dim = ssm_dims(cfg)
        per_kind["mamba"] = batch * ((cfg.ssm_conv_width - 1) * conv_dim
                                     + nh * cfg.ssm_state * cfg.ssm_head_dim)
    if cfg.arch_type == "ssm":
        h, hd = rwkv_heads(cfg)
        per_kind["rwkv"] = batch * (2 * cfg.d_model + h * hd * hd)
    total = sum(per_kind[k] for k in cfg.layer_kinds())
    if cfg.is_encoder_decoder:
        total += cfg.n_layers * 2 * batch * cfg.encoder_seq * cfg.n_heads \
            * cfg.resolved_head_dim
    return total * 4 / 1e6


class ModelContainer:
    """A warm, executable instance of one model on ``device`` (CUDA
    unless ``"cpu"``), with random weights seeded from ``seed``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 max_batch: int = 4, max_len: int = 256, device=None):
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = resolve_device(device)
        self._frames = None
        t0 = time.perf_counter()
        self.params = init_params(cfg, seed, self.device)
        self.prefill_len = min(32, max_len // 2)
        self._warm_up()
        self.cold_start_s = time.perf_counter() - t0
        self.size_mb = pytree_mb(self.params) + cache_mb(cfg, max_batch,
                                                         max_len)

    def _batch(self, tokens: torch.Tensor, pos0: int) -> dict:
        """The reference's ``_dummy_batch`` with these tokens: positions
        ``pos0 ..``, as (t, t, t) for a VLM; for whisper zero frame
        embeddings f32 [B, S_enc, D] (made once)."""
        b, s = tokens.shape
        pos = torch.arange(pos0, pos0 + s, dtype=torch.int32,
                           device=self.device)[None].expand(b, s)
        batch = {"tokens": tokens, "positions": pos, "seq_positions": pos}
        if self.cfg.is_encoder_decoder:
            if self._frames is None or self._frames.shape[0] != b:
                self._frames = torch.zeros(
                    (b, self.cfg.encoder_seq, self.cfg.d_model),
                    dtype=torch.float32, device=self.device)
            batch["frame_embeds"] = self._frames
        if self.cfg.arch_type == "vlm":
            batch["positions"] = pos[..., None].expand(b, s, 3)
        return batch

    def _warm_up(self):
        """One prefill and one decode at the serving shapes."""
        b, s = self.max_batch, self.prefill_len
        zeros = torch.zeros(b, s, dtype=torch.int32, device=self.device)
        _, caches = prefill(self.cfg, self.params, self._batch(zeros, 0),
                            cache_len=self.max_len)
        decode_step(self.cfg, self.params, self._batch(zeros[:, :1], s),
                    caches)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate_with_logits(self, tokens: np.ndarray, n_new: int
                             ) -> tuple[np.ndarray, torch.Tensor]:
        """Greedy continuation of ``tokens`` i32[B, S0] (B <= max_batch).

        The prompt is right-padded with zeros (and cut) to the prefill
        length ``min(32, max_len // 2)`` for a batch of ``max_batch``;
        prefill, then ``n_new - 1`` decode steps at positions s, s+1, ...
        Returns the first B rows: tokens i32[B, n_new] (argmax of f32
        logits) and those logits f32[B, n_new, V] on the device."""
        b, s0 = tokens.shape
        s = self.prefill_len
        toks = np.zeros((self.max_batch, s), np.int32)
        toks[:b, :min(s0, s)] = tokens[:, :s]
        batch = self._batch(torch.from_numpy(toks).to(self.device), 0)
        logits, caches = prefill(self.cfg, self.params, batch,
                                 cache_len=self.max_len)
        steps = [logits[:, -1]]
        for i in range(n_new - 1):
            nxt = steps[-1].argmax(-1).to(torch.int32)[:, None]
            logits, caches = decode_step(self.cfg, self.params,
                                         self._batch(nxt, s + i), caches)
            steps.append(logits[:, -1])
        logits = torch.stack(steps, dim=1)[:b]
        out = logits.argmax(-1).to(torch.int32).cpu().numpy()
        return out, logits

    def generate(self, tokens: np.ndarray, n_new: int) -> np.ndarray:
        """Greedy continuation: tokens i32[B, n_new]
        (see :meth:`generate_with_logits`)."""
        return self.generate_with_logits(tokens, n_new)[0]
