"""GQA attention with a KV cache (full or sliding-window ring), RoPE and
M-RoPE; port of ``repro.models.attention``.

Unlike the reference, whose arrays are immutable, the cache is written in
place: ``attention_prefill`` fills a new cache and ``attention_decode``
writes its one slot into the cache it is given (and returns that same
cache), so a container decodes without copying its cache arena each
step.  Cross-attention (the whisper decoder against the encoder's
states) runs the prefill kernel without the causal mask.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from .config import ModelConfig
from .layers import dense, dense_init
from .rope import apply_rope, rope_angles


class KVCache(NamedTuple):
    """Decode-time KV cache.  For windowed attention the buffer is a ring of
    ``window`` slots (slot = pos % window); otherwise slot = pos.

    k, v: [B, S_c, KV, D]; slot_pos: i32[B, S_c] absolute position held in
    each slot (-1 = empty).
    """

    k: torch.Tensor
    v: torch.Tensor
    slot_pos: torch.Tensor


def cache_slots(cfg: ModelConfig, max_len: int) -> int:
    """Slots of one layer's cache: the window when there is one."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> KVCache:
    s = cache_slots(cfg, max_len)
    kv, d = cfg.n_kv_heads, cfg.resolved_head_dim
    return KVCache(
        k=torch.zeros(batch, s, kv, d, dtype=dtype, device=device),
        v=torch.zeros(batch, s, kv, d, dtype=dtype, device=device),
        slot_pos=torch.full((batch, s), -1, dtype=torch.int32,
                            device=device),
    )


def attn_init(gen, cfg: ModelConfig, *, device="cpu") -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    kw = dict(bias=cfg.qkv_bias, device=device)
    return {
        "wq": dense_init(gen, d, h * hd, cfg.dtype, **kw),
        "wk": dense_init(gen, d, kv * hd, cfg.dtype, **kw),
        "wv": dense_init(gen, d, kv * hd, cfg.dtype, **kw),
        "wo": dense_init(gen, h * hd, d, cfg.dtype, device=device),
    }


def _split_heads(x, n, d):
    return x.reshape(*x.shape[:-1], n, d)


def _window(cfg: ModelConfig, window_override):
    return window_override if window_override is not None \
        else cfg.sliding_window


def attention_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, *,
                      make_cache: bool = False,
                      cache_len: int = 0,
                      window_override: Optional[int] = None,
                      causal: bool = True,
                      seq_positions: Optional[torch.Tensor] = None,
                      ) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Full-sequence causal attention (train / prefill).

    x: [B, S, D_model]; positions: i32[B, S] (or [B, S, 3] for M-RoPE).
    ``seq_positions`` i32[B, S]: absolute *sequence* indices used for cache
    slots — distinct from rope ``positions`` because M-RoPE temporal ids
    collide across vision patches.  Defaults to ``positions`` when 1-D,
    else to 0..S-1.  When ``make_cache`` the resulting KV cache
    (ring-buffered if windowed) sized ``cache_len`` (>= S) is returned for
    subsequent decode; with a window and ``S`` above the ring's size it
    keeps the last tokens only.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    window = _window(cfg, window_override)

    q = _split_heads(dense(p["wq"], x), h, hd)
    k = _split_heads(dense(p["wk"], x), kv, hd)
    v = _split_heads(dense(p["wv"], x), kv, hd)
    if cfg.rope_theta:  # rope_theta == 0 => learned positions (whisper)
        ang = rope_angles(positions, hd, cfg.rope_theta, cfg.mrope_sections)
        q, k = apply_rope(q, ang), apply_rope(k, ang)

    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window)
    y = dense(p["wo"], o.reshape(b, s, h * hd))

    cache = None
    if make_cache:
        cache = init_cache(cfg, b, max(cache_len, s), dtype=k.dtype,
                           device=x.device)
        sc = cache.k.shape[1]
        if seq_positions is not None:
            pos1d = seq_positions
        elif positions.ndim == 2:
            pos1d = positions
        else:
            pos1d = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        pos1d = pos1d.to(torch.int32).expand(b, s)
        if window and s > sc:
            # keep only the last `sc` tokens in the ring
            k_tail, v_tail = k[:, -sc:], v[:, -sc:]
            pos_tail = pos1d[:, -sc:]
        else:
            k_tail, v_tail, pos_tail = k, v, pos1d
        slots = (pos_tail % sc) if window else pos_tail
        bi = torch.arange(b, device=x.device)[:, None]
        slots = slots.long()
        cache.k[bi, slots] = k_tail
        cache.v[bi, slots] = v_tail
        cache.slot_pos[bi, slots] = pos_tail
    return y, cache


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     positions: torch.Tensor, cache: KVCache, *,
                     window_override: Optional[int] = None,
                     seq_positions: Optional[torch.Tensor] = None,
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode step: writes this token's slot into ``cache`` in
    place, then attends over it.

    x: [B, 1, D_model]; positions: i32[B, 1] (or [B, 1, 3]); returns
    ([B, 1, D_model], the cache)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    window = _window(cfg, window_override)

    q = _split_heads(dense(p["wq"], x), h, hd)[:, 0]      # [B,H,D]
    k = _split_heads(dense(p["wk"], x), kv, hd)[:, 0]     # [B,KV,D]
    v = _split_heads(dense(p["wv"], x), kv, hd)[:, 0]
    if cfg.rope_theta:
        ang = rope_angles(positions, hd, cfg.rope_theta, cfg.mrope_sections)
        q = apply_rope(q[:, None], ang)[:, 0]
        k = apply_rope(k[:, None], ang)[:, 0]

    if seq_positions is not None:
        pos1d = seq_positions[:, 0]
    elif positions.ndim == 2:
        pos1d = positions[:, 0]
    else:
        raise ValueError("M-RoPE decode needs explicit seq_positions "
                         "(temporal ids collide)")
    pos1d = pos1d.to(torch.int32).expand(b)
    sc = cache.k.shape[1]
    slot = ((pos1d % sc) if window else pos1d).long()
    bi = torch.arange(b, device=x.device)
    cache.k[bi, slot] = k.to(cache.k.dtype)
    cache.v[bi, slot] = v.to(cache.v.dtype)
    cache.slot_pos[bi, slot] = pos1d
    o = ops.decode_attention(q.contiguous(), cache.k, cache.v,
                             cache.slot_pos, pos1d, window=window)
    y = dense(p["wo"], o.reshape(b, 1, h * hd))
    return y, cache


# ---------------------------------------------------------------------------
# cross attention (whisper decoder -> encoder states)
# ---------------------------------------------------------------------------

def cross_attn_init(gen, cfg: ModelConfig, *, device="cpu") -> dict:
    return attn_init(gen, cfg, device=device)


def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D]; enc_k/enc_v: [B, S_enc, H, hd] (precomputed by
    :func:`encode_cross_kv`).  Every query sees every encoder frame."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = _split_heads(dense(p["wq"], x), h, hd)
    o = ops.flash_attention(q.contiguous(), enc_k.contiguous(),
                            enc_v.contiguous(), causal=False)
    return dense(p["wo"], o.reshape(b, s, h * hd))


def encode_cross_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor):
    """The encoder states' keys and values [B, S_enc, H, hd] for one
    decoder layer's cross-attention (whisper is MHA: H kv heads)."""
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    k = _split_heads(dense(p["wk"], enc_out), h, hd)
    v = _split_heads(dense(p["wv"], enc_out), h, hd)
    return k, v
