"""Decoder-only transformer, dense path; port of
``repro.models.transformer``.

* ``init_params(cfg, seed, device)``
* ``forward_train(cfg, params, batch)``          -> (logits, aux)
* ``prefill(cfg, params, batch, cache_len)``     -> (logits, caches)
* ``decode(cfg, params, batch, caches)``         -> (logits, caches)

The reference scans stacked layer params; here ``params["layers"]`` is a
list of per-layer dicts and the stack is a Python loop over it, and the
caches are a list of per-layer ``KVCache``s.  ``forward_train`` is the
no-cache forward, without rematerialisation.  Other families raise
``NotImplementedError`` naming their ROADMAP item until their slice lands
(at ``init_params``/``init_caches``: no params exist for them to run).

``batch`` keys: ``tokens`` i32[B,S] (or ``embeds`` f32[B,S,D]),
``positions`` i32[B,S], optionally ``seq_positions`` i32[B,S].
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._device import resolve_device
from .attention import (KVCache, attention_decode, attention_prefill,
                        attn_init, init_cache)
from .config import ModelConfig
from .layers import _dtype, dense, dense_init, embed, embedding_init, mlp, mlp_init, \
    norm, norm_init

#: Families other than dense, and the ROADMAP item that brings each.
NOT_PORTED = {
    "moe": "moe.py (ROADMAP A15)",
    "hybrid": "ssm.py and kernel B4 (ROADMAP A15, B4)",
    "ssm": "rwkv.py and kernel B5 (ROADMAP A15, B5)",
    "vlm": "the VLM frontends (ROADMAP A15)",
    "audio": "whisper (ROADMAP A15)",
}


class Aux(NamedTuple):
    moe_aux: torch.Tensor
    router_entropy: torch.Tensor


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless this slice runs ``cfg``'s family."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models come with "
            f"{NOT_PORTED['audio']}")
    if cfg.arch_type != "dense" or cfg.is_moe:
        kind = "moe" if cfg.is_moe else cfg.arch_type
        raise NotImplementedError(
            f"{cfg.name}: the {kind} family comes with "
            f"{NOT_PORTED.get(kind, 'a later slice')}")


def _device(device):
    return torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_layer_init(gen, cfg: ModelConfig, device) -> dict:
    return {"ln1": norm_init(cfg.d_model, cfg.norm_type, "float32",
                             device=device),
            "attn": attn_init(gen, cfg, device=device),
            "ln2": norm_init(cfg.d_model, cfg.norm_type, "float32",
                             device=device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype,
                            device=device)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random weights in ``cfg.dtype`` (norms in f32) from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (CUDA unless
    ``"cpu"``; ``"meta"`` gives shapes and dtypes without allocating)."""
    check_supported(cfg)
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
    params["layers"] = [_attn_layer_init(gen, cfg, dev)
                        for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_block(cfg, lp, x, positions, *, mode, cache=None,
                cache_len=0, window=None, seq_positions=None):
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
    x = x + h
    x = x + mlp(lp["mlp"], norm(lp["ln2"], x, cfg.norm_eps), cfg.act)
    return x, new_cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, params, batch) -> torch.Tensor:
    compute = _dtype(cfg.dtype)
    if batch.get("embeds") is not None:
        return batch["embeds"].to(compute)
    return embed(params["embed"], batch["tokens"].long(), compute)


def _head(cfg: ModelConfig, params, x) -> torch.Tensor:
    """Final norm and vocabulary projection; logits in f32."""
    x = norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return (x @ params["embed"]["emb"].to(x.dtype).T).float()
    return dense(params["lm_head"], x).float()


def _zero_aux(x) -> Aux:
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return Aux(zero, zero)


def _run_stack(cfg: ModelConfig, params, x, positions, *, mode,
               caches=None, cache_len=0, window=None, seq_positions=None):
    """Run the layer stack, one layer after another.  Returns
    (x, caches or None)."""
    new_caches = []
    for i, lp in enumerate(params["layers"]):
        x, c = _attn_block(cfg, lp, x, positions, mode=mode,
                           cache=caches[i] if caches is not None else None,
                           cache_len=cache_len, window=window,
                           seq_positions=seq_positions)
        new_caches.append(c)
    return x, (new_caches if mode != "train" else None)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward_train(cfg: ModelConfig, params, batch):
    """The no-cache forward over the whole sequence: (logits f32
    [B, S, V], Aux of zeros)."""
    x = _embed_inputs(cfg, params, batch)
    x, _ = _run_stack(cfg, params, x, batch.get("positions"), mode="train")
    return _head(cfg, params, x), _zero_aux(x)


def prefill(cfg: ModelConfig, params, batch, *, cache_len: int = 0,
            window: int | None = None):
    """Logits f32 [B, 1, V] at the last position, and per-layer caches."""
    x = _embed_inputs(cfg, params, batch)
    x, caches = _run_stack(cfg, params, x, batch.get("positions"),
                           mode="prefill", cache_len=cache_len,
                           window=window,
                           seq_positions=batch.get("seq_positions"))
    return _head(cfg, params, x[:, -1:]), caches


def decode(cfg: ModelConfig, params, batch, caches, *,
           window: int | None = None):
    """One token: logits f32 [B, 1, V], and the caches, written in
    place."""
    x = _embed_inputs(cfg, params, batch)
    x, caches = _run_stack(cfg, params, x, batch.get("positions"),
                           mode="decode", caches=caches, window=window,
                           seq_positions=batch.get("seq_positions"))
    return _head(cfg, params, x), caches


# ---------------------------------------------------------------------------
# cache init for decode-only entry
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, window: int | None = None,
                device=None) -> list[KVCache]:
    """Blank per-layer caches.  ``window`` caps each to a ring of that
    many slots."""
    check_supported(cfg)
    eff_len = min(max_len, window) if window else max_len
    dev = _device(device)
    return [init_cache(cfg, batch, eff_len, dtype, device=dev)
            for _ in range(cfg.n_layers)]
