"""Decoder-only stacks of the dense, hybrid (zamba2) and SSM (rwkv6)
families; port of ``repro.models.transformer``.

* ``init_params(cfg, seed, device)``
* ``forward_train(cfg, params, batch)``          -> (logits, aux)
* ``prefill(cfg, params, batch, cache_len)``     -> (logits, caches)
* ``decode(cfg, params, batch, caches)``         -> (logits, caches)

The reference scans stacked layer params for the dense and RWKV stacks;
here ``params["layers"]`` is a list of per-layer dicts and every stack is
a Python loop over it, and the caches are a list with one entry a layer
(``KVCache``, ``SSMCache`` or ``RWKVCache``).  The hybrid keeps the
reference's layout: ``params["layers"]`` holds a Mamba layer at each
``"mamba"`` position and ``None`` at each ``"attn"`` position, where the
one ``params["shared_attn"]`` block runs, with a ``KVCache`` of its own at
each position.  ``forward_train`` is the no-cache forward, without
rematerialisation.  The MoE, VLM and audio families raise
``NotImplementedError`` naming their ROADMAP item until their slice lands
(at ``init_params``/``init_caches``: no params exist for them to run).

``batch`` keys: ``tokens`` i32[B,S] (or ``embeds`` f32[B,S,D]),
``positions`` i32[B,S], optionally ``seq_positions`` i32[B,S].
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._device import resolve_device
from .attention import (attention_decode, attention_prefill, attn_init,
                        init_cache)
from .config import ModelConfig
from .layers import _dtype, dense, dense_init, embed, embedding_init, mlp, mlp_init, \
    norm, norm_init
from .rwkv import (RWKVCache, channel_mix, init_rwkv_cache, rwkv_init,
                   time_mix)
from .ssm import init_ssm_cache, ssm_decode, ssm_init, ssm_prefill

#: Families not ported yet, and the ROADMAP item that brings each.
NOT_PORTED = {
    "moe": "moe.py (ROADMAP A15)",
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
    kind = "moe" if cfg.is_moe else cfg.arch_type
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {kind} family comes with {NOT_PORTED[kind]}")


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


def _mamba_block(cfg, lp, x, *, mode, cache=None):
    z = norm(lp["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        h, new_cache = ssm_decode(cfg, lp["ssm"], z, cache)
    else:
        h, new_cache = ssm_prefill(cfg, lp["ssm"], z,
                                   make_cache=(mode == "prefill"))
    return x + h, new_cache


def _rwkv_block(cfg, lp, x, *, cache: RWKVCache | None = None):
    ltm, lcm, st = cache if cache is not None else (None, None, None)
    h, new_ltm, new_state = time_mix(cfg, lp["rwkv"],
                                     norm(lp["ln1"], x, cfg.norm_eps),
                                     ltm, st)
    x = x + h
    h, new_lcm = channel_mix(cfg, lp["rwkv"],
                             norm(lp["ln2"], x, cfg.norm_eps), lcm)
    x = x + h
    return x, RWKVCache(new_ltm, new_lcm, new_state)


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
    """Run the layer stack, one layer after another (the hybrid's
    attention positions through the shared block).  Returns (x, caches or
    None)."""
    new_caches = []
    for i, kind in enumerate(cfg.layer_kinds()):
        c = caches[i] if caches is not None else None
        if kind == "mamba":
            x, c = _mamba_block(cfg, params["layers"][i], x, mode=mode,
                                cache=c)
        elif kind == "rwkv":
            x, c = _rwkv_block(cfg, params["layers"][i], x, cache=c)
        else:
            lp = params["shared_attn"] if cfg.arch_type == "hybrid" \
                else params["layers"][i]
            x, c = _attn_block(cfg, lp, x, positions, mode=mode, cache=c,
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
                device=None) -> list:
    """Blank per-layer caches: a ``KVCache`` at each attention position
    (``window`` caps it to a ring of that many slots), an ``SSMCache`` at
    each Mamba layer and an ``RWKVCache`` at each RWKV layer."""
    check_supported(cfg)
    eff_len = min(max_len, window) if window else max_len
    dev = _device(device)
    make = {"attn": lambda: init_cache(cfg, batch, eff_len, dtype,
                                       device=dev),
            "mamba": lambda: init_ssm_cache(cfg, batch, dtype, device=dev),
            "rwkv": lambda: init_rwkv_cache(cfg, batch, dtype, device=dev)}
    return [make[kind]() for kind in cfg.layer_kinds()]
