"""Attention and scan entry points, dispatched by the tensor's device.

Port of ``repro.kernels.ops``.  A CUDA tensor runs the hand-written
kernel; a CPU tensor runs the kernel's plain version; any other device
raises.  There is no switch that sends a CUDA tensor to the plain version
(the reference's ``REPRO_FORCE_REF`` is not carried over): on the card
the kernel runs or the call raises.

The single-token updates ``ssm_decode_step`` and ``wkv6_decode_step``
are plain torch on every device, as in the reference ("no kernel
warranted").  The rwkv6 model decodes through ``wkv6`` with S = 1, as the
reference's does.
"""
from __future__ import annotations

from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .ssm_scan import ssm_decode_step, ssm_scan_cuda, ssm_scan_plain
from .wkv6 import wkv6_cuda, wkv6_decode_step, wkv6_plain

__all__ = ["decode_attention", "flash_attention", "ssm_decode_step",
           "ssm_scan", "wkv6", "wkv6_decode_step"]


def _route(what: str, t, kernel, plain):
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no {what} for tensors on {t.device}")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    q_offset=0):
    """q [B, Sq, H, D], k/v [B, Skv, KV, D] -> [B, Sq, H, D]."""
    fn = _route("attention", q, flash_attention_cuda,
                flash_attention_plain)
    return fn(q, k, v, causal=causal, window=window, scale=scale,
              q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *,
                     window=None, scale=None):
    """q [B, H, D] against k/v [B, S, KV, D] -> [B, H, D]."""
    fn = _route("attention", q, decode_attention_cuda,
                decode_attention_plain)
    return fn(q, k_cache, v_cache, slot_pos, cur_pos, window=window,
              scale=scale)


def ssm_scan(x, dt, a, b, c, *, h0=None):
    """x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,H,N] ->
    (y [B,S,H,P], h_final [B,H,N,P] f32)."""
    fn = _route("ssm_scan", x, ssm_scan_cuda, ssm_scan_plain)
    return fn(x, dt, a, b, c, h0=h0)


def wkv6(r, k, v, w, u, *, state=None):
    """r/k/v/w [B,S,H,D], u [H,D] -> (y [B,S,H,D], state [B,H,D,D] f32)."""
    fn = _route("wkv6", r, wkv6_cuda, wkv6_plain)
    return fn(r, k, v, w, u, state=state)
