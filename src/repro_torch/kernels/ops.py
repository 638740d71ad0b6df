"""Attention and scan entry points, dispatched by the tensor's device.

Port of ``repro.kernels.ops``.  A CUDA tensor runs the hand-written
kernel; a CPU tensor runs the kernel's plain version; any other device
raises.  There is no switch that sends a CUDA tensor to the plain version
(the reference's ``REPRO_FORCE_REF`` is not carried over): on the card
the kernel runs or the call raises.

``ssm_scan`` and ``wkv6`` raise until their kernels (ROADMAP B4, B5)
land with the zamba2 and rwkv6 models; their single-token steps come
with ``ssm.py`` and ``rwkv.py`` (A15).
"""
from __future__ import annotations

from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain


def _route(t, kernel, plain):
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no attention for tensors on {t.device}")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    q_offset=0):
    """q [B, Sq, H, D], k/v [B, Skv, KV, D] -> [B, Sq, H, D]."""
    fn = _route(q, flash_attention_cuda, flash_attention_plain)
    return fn(q, k, v, causal=causal, window=window, scale=scale,
              q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *,
                     window=None, scale=None):
    """q [B, H, D] against k/v [B, S, KV, D] -> [B, H, D]."""
    fn = _route(q, decode_attention_cuda, decode_attention_plain)
    return fn(q, k_cache, v_cache, slot_pos, cur_pos, window=window,
              scale=scale)


def ssm_scan(*args, **kwargs):
    raise NotImplementedError("ssm_scan: the Mamba2 SSD kernel is ROADMAP "
                              "B4, not yet ported")


def wkv6(*args, **kwargs):
    raise NotImplementedError("wkv6: the RWKV6 WKV kernel is ROADMAP B5, "
                              "not yet ported")

