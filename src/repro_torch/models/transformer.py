"""Decoder-only stacks of the dense, MoE, VLM, hybrid (zamba2) and SSM
(rwkv6) families; port of ``repro.models.transformer``.

* ``init_params(cfg, seed, device)``
* ``forward_train(cfg, params, batch, remat)``   -> (logits, aux)
* ``prefill(cfg, params, batch, cache_len)``     -> (logits, caches)
* ``decode(cfg, params, batch, caches)``         -> (logits, caches)

The reference scans stacked layer params for the dense and RWKV stacks;
here ``params["layers"]`` is a list of per-layer dicts and every stack is
a Python loop over it, and the caches are a list with one entry a layer
(``KVCache``, ``SSMCache`` or ``RWKVCache``).  The hybrid keeps the
reference's layout: ``params["layers"]`` holds a Mamba layer at each
``"mamba"`` position and ``None`` at each ``"attn"`` position, where the
one ``params["shared_attn"]`` block runs, with a ``KVCache`` of its own at
each position.  ``forward_train`` is the no-cache forward; with
``remat`` each layer runs under ``torch.utils.checkpoint`` (its
activations recomputed in the backward pass), the hybrid's layers too,
which the reference's Python loop leaves to XLA.  An MoE model's
attention layers carry ``moe`` in place of ``mlp``.  The whisper
encoder-decoder is ``whisper.py``.

``batch`` keys: ``tokens`` i32[B,S] (or ``embeds`` f32[B,S,D]),
``positions`` i32[B,S] (or [B,S,3] for M-RoPE), optionally
``seq_positions`` i32[B,S]; a VLM's ``patch_embeds`` [B,P,D] are spliced
in at ``patch_positions`` i32[B,P].
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from . import partitioning
from .attention import (attention_decode, attention_prefill, attn_init,
                        init_cache)
from .config import ModelConfig
from .layers import _dtype, dense, dense_init, embed, embedding_init, mlp, mlp_init, \
    norm, norm_init
from .moe import moe_apply, moe_init
from .rwkv import (RWKVCache, channel_mix, init_rwkv_cache, rwkv_init,
                   time_mix)
from .ssm import init_ssm_cache, ssm_decode, ssm_init, ssm_prefill

class Aux(NamedTuple):
    moe_aux: torch.Tensor
    router_entropy: torch.Tensor


def _device(device):
    return torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_layer_init(gen, cfg: ModelConfig, device) -> dict:
    p = {"ln1": norm_init(cfg.d_model, cfg.norm_type, "float32",
                          device=device),
         "attn": attn_init(gen, cfg, device=device),
         "ln2": norm_init(cfg.d_model, cfg.norm_type, "float32",
                          device=device)}
    if cfg.is_moe:
        p["moe"] = moe_init(gen, cfg, device=device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype,
                            device=device)
    return p


def _mamba_layer_init(gen, cfg: ModelConfig, device) -> dict:
    return {"ln1": norm_init(cfg.d_model, cfg.norm_type, "float32",
                             device=device),
            "ssm": ssm_init(gen, cfg, device=device)}


def _rwkv_layer_init(gen, cfg: ModelConfig, device) -> dict:
    return {"ln1": norm_init(cfg.d_model, cfg.norm_type, "float32",
                             device=device),
            "ln2": norm_init(cfg.d_model, cfg.norm_type, "float32",
                             device=device),
            "rwkv": rwkv_init(gen, cfg, device=device)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random weights in ``cfg.dtype`` (norms in f32) from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (CUDA unless
    ``"cpu"``; ``"meta"`` gives shapes and dtypes without allocating)."""
    dev = _device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    params: dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype,
                                device=dev),
        "final_norm": norm_init(cfg.d_model, cfg.norm_type, "float32",
                                device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       cfg.dtype, device=dev)
    kinds = cfg.layer_kinds()
    if cfg.arch_type == "hybrid":
        # attention positions run the SHARED block; their slot is empty
        params["layers"] = [_mamba_layer_init(gen, cfg, dev)
                            if kind == "mamba" else None for kind in kinds]
        params["shared_attn"] = _attn_layer_init(gen, cfg, dev)
    else:
        init_one = _rwkv_layer_init if cfg.arch_type == "ssm" \
            else _attn_layer_init
        params["layers"] = [init_one(gen, cfg, dev) for _ in kinds]
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_block(cfg, lp, x, positions, *, mode, cache=None,
                cache_len=0, window=None, seq_positions=None, rows=None):
    z = norm(lp["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        h, new_cache = attention_decode(cfg, lp["attn"], z, positions, cache,
                                        window_override=window,
                                        seq_positions=seq_positions)
    else:
        h, new_cache = attention_prefill(cfg, lp["attn"], z, positions,
                                         make_cache=(mode == "prefill"),
                                         cache_len=cache_len,
                                         window_override=window,
                                         seq_positions=seq_positions)
    x = partitioning.hidden(x + h)
    z = norm(lp["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        out = moe_apply(cfg, lp["moe"], z, rows=rows)
        return partitioning.hidden(x + out.y), new_cache, \
            Aux(out.aux_loss, out.router_entropy)
    return partitioning.hidden(x + mlp(lp["mlp"], z, cfg.act)), new_cache, \
        _zero_aux(x)


def _mamba_block(cfg, lp, x, *, mode, cache=None):
    z = norm(lp["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        h, new_cache = ssm_decode(cfg, lp["ssm"], z, cache)
    else:
        h, new_cache = ssm_prefill(cfg, lp["ssm"], z,
                                   make_cache=(mode == "prefill"))
    return partitioning.hidden(x + h), new_cache


def _rwkv_block(cfg, lp, x, *, cache: RWKVCache | None = None):
    ltm, lcm, st = cache if cache is not None else (None, None, None)
    h, new_ltm, new_state = time_mix(cfg, lp["rwkv"],
                                     norm(lp["ln1"], x, cfg.norm_eps),
                                     ltm, st)
    x = partitioning.hidden(x + h)
    h, new_lcm = channel_mix(cfg, lp["rwkv"],
                             norm(lp["ln2"], x, cfg.norm_eps), lcm)
    x = partitioning.hidden(x + h)
    return x, RWKVCache(new_ltm, new_lcm, new_state)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Token embeddings (or ``embeds``), with a VLM's ``patch_embeds``
    written over the rows at ``patch_positions``."""
    compute = _dtype(cfg.dtype)
    if batch.get("embeds") is not None:      # a copy: patches write in
        x = batch["embeds"].to(compute, copy=True)
    else:
        x = embed(params["embed"], batch["tokens"].long(), compute)
    if batch.get("patch_embeds") is not None:
        bi = torch.arange(x.shape[0], device=x.device)[:, None]
        x[bi, batch["patch_positions"].long()] = \
            batch["patch_embeds"].to(compute)
    return partitioning.hidden(x)


def _head(cfg: ModelConfig, params, x) -> torch.Tensor:
    """Final norm and vocabulary projection; logits in f32."""
    x = norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return partitioning.logits(
            (x @ params["embed"]["emb"].to(x.dtype).T).float())
    return partitioning.logits(dense(params["lm_head"], x).float())


def _zero_aux(x) -> Aux:
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return Aux(zero, zero)


def _run_stack(cfg: ModelConfig, params, x, positions, *, mode,
               caches=None, cache_len=0, window=None, seq_positions=None,
               remat=False, rows=None):
    """Run the layer stack, one layer after another (the hybrid's
    attention positions through the shared block), each layer under
    ``checkpoint`` when ``remat`` (with ``partitioning``'s selective
    policy when one is set).  Returns (x, caches or None, Aux):
    ``moe_aux`` summed over the layers, ``router_entropy`` averaged over
    a homogeneous stack and summed over a hybrid's, as the reference's
    scan and loop give them; with ``rows`` (a batch split across ranks,
    ``moe.moe_apply``) this rank's shares of them."""
    policy = partitioning.remat_policy() if remat else None

    def run(block, *args, **kw):
        if not remat:
            return block(*args, **kw)
        if policy is not None:
            kw["context_fn"] = policy
        # the layers draw no random numbers: no RNG state to keep
        return checkpoint(block, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    new_caches, auxs = [], []
    for i, kind in enumerate(cfg.layer_kinds()):
        c = caches[i] if caches is not None else None
        if kind == "mamba":
            x, c = run(_mamba_block, cfg, params["layers"][i], x, mode=mode,
                       cache=c)
        elif kind == "rwkv":
            x, c = run(_rwkv_block, cfg, params["layers"][i], x, cache=c)
        else:
            lp = params["shared_attn"] if cfg.arch_type == "hybrid" \
                else params["layers"][i]
            x, c, a = run(_attn_block, cfg, lp, x, positions, mode=mode,
                          cache=c, cache_len=cache_len, window=window,
                          seq_positions=seq_positions, rows=rows)
            auxs.append(a)
        new_caches.append(c)
    aux = _zero_aux(x)
    if cfg.is_moe and auxs:
        entropy = torch.stack([a.router_entropy for a in auxs]).sum()
        if cfg.arch_type != "hybrid":
            entropy = entropy / len(auxs)
        aux = Aux(torch.stack([a.moe_aux for a in auxs]).sum(), entropy)
    return x, (new_caches if mode != "train" else None), aux


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward_train(cfg: ModelConfig, params, batch, *, remat: bool = True,
                  rows=None):
    """The no-cache forward over the whole sequence: (logits f32
    [B, S, V], Aux; zeros but for an MoE model).  ``remat`` recomputes
    each layer's activations in the backward pass; ``rows``: see
    ``_run_stack``."""
    x = _embed_inputs(cfg, params, batch)
    x, _, aux = _run_stack(cfg, params, x, batch.get("positions"),
                           mode="train", remat=remat, rows=rows)
    return _head(cfg, params, x), aux


def prefill(cfg: ModelConfig, params, batch, *, cache_len: int = 0,
            window: int | None = None):
    """Logits f32 [B, 1, V] at the last position, and per-layer caches."""
    x = _embed_inputs(cfg, params, batch)
    x, caches, _ = _run_stack(cfg, params, x, batch.get("positions"),
                              mode="prefill", cache_len=cache_len,
                              window=window,
                              seq_positions=batch.get("seq_positions"))
    return _head(cfg, params, x[:, -1:]), caches


def decode(cfg: ModelConfig, params, batch, caches, *,
           window: int | None = None):
    """One token: logits f32 [B, 1, V], and the caches, written in
    place."""
    x = _embed_inputs(cfg, params, batch)
    x, caches, _ = _run_stack(cfg, params, x, batch.get("positions"),
                              mode="decode", caches=caches, window=window,
                              seq_positions=batch.get("seq_positions"))
    return _head(cfg, params, x), caches


# ---------------------------------------------------------------------------
# cache init for decode-only entry
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, window: int | None = None,
                device=None) -> list:
    """Blank per-layer caches: a ``KVCache`` at each attention position
    (``window`` caps it to a ring of that many slots), an ``SSMCache`` at
    each Mamba layer and an ``RWKVCache`` at each RWKV layer."""
    eff_len = min(max_len, window) if window else max_len
    dev = _device(device)
    make = {"attn": lambda: init_cache(cfg, batch, eff_len, dtype,
                                       device=dev),
            "mamba": lambda: init_ssm_cache(cfg, batch, dtype, device=dev),
            "rwkv": lambda: init_rwkv_cache(cfg, batch, dtype, device=dev)}
    return [make[kind]() for kind in cfg.layer_kinds()]
