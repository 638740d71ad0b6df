"""Attention and scan entry points, dispatched by the tensor's device.

Port of ``repro.kernels.ops``.  A CUDA tensor runs the hand-written
kernel; a CPU tensor runs the kernel's plain version; any other device
raises.  There is no switch that sends a CUDA tensor to the plain version
(the reference's ``REPRO_FORCE_REF`` is not carried over): on the card
the kernel runs or the call raises.

Gradients.  A kernel writes its output through a raw pointer, so autograd
cannot see through it.  When a gradient is needed (grad mode on and an
input that requires grad), B3, B4 and B5 run inside a
``torch.autograd.Function`` whose forward launches the kernel and whose
backward is the kernel module's explicit plain-torch gradient
(``flash_attention_bwd``, ``ssm_scan_bwd``, ``wkv6_bwd``; the reference
has no backward kernel, its ``jax.grad`` differentiates the oracles).
Otherwise the kernel is called directly, as serving calls it.  On the
CPU the plain versions run and autograd differentiates them.
:func:`flash_attention_function`, :func:`ssm_scan_function` and
:func:`wkv6_function` build the Functions around any forward with the
kernel's signature, so that the CPU tests can run them with the plain
version in the kernel's place.

The single-token updates ``ssm_decode_step`` and ``wkv6_decode_step``
are plain torch on every device, as in the reference ("no kernel
warranted").  The rwkv6 model decodes through ``wkv6`` with S = 1, as the
reference's does.
"""
from __future__ import annotations

import torch

from .decode_attention import decode_attention_cuda, decode_attention_plain
from .flash_attention import (flash_attention_bwd, flash_attention_cuda,
                              flash_attention_plain)
from .ssm_scan import (ssm_decode_step, ssm_scan_bwd, ssm_scan_cuda,
                       ssm_scan_plain)
from .wkv6 import wkv6_bwd, wkv6_cuda, wkv6_decode_step, wkv6_plain

__all__ = ["decode_attention", "flash_attention", "ssm_decode_step",
           "ssm_scan", "wkv6", "wkv6_decode_step"]


def _route(what: str, t, kernel, plain):
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no {what} for tensors on {t.device}")


def needs_grad(*tensors) -> bool:
    """Grad mode is on and some input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def flash_attention_function(forward):
    """A ``torch.autograd.Function`` for B3 around ``forward`` (the
    kernel's signature): ``.apply(q, k, v, causal, window, scale,
    q_offset)``; its backward is :func:`flash_attention_bwd`."""
    class FlashAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window, scale, q_offset):
            ctx.save_for_backward(q, k, v)
            ctx.opts = dict(causal=causal, window=window, scale=scale,
                            q_offset=q_offset)
            return forward(q, k, v, **ctx.opts)

        @staticmethod
        def backward(ctx, do):
            grads = flash_attention_bwd(*ctx.saved_tensors,
                                        do.contiguous(), **ctx.opts)
            return (*grads, None, None, None, None)
    return FlashAttention


def ssm_scan_function(forward):
    """A ``torch.autograd.Function`` for B4 around ``forward`` (the
    kernel's signature): ``.apply(x, dt, a, b, c, h0)`` -> (y, h_final);
    its backward is :func:`ssm_scan_bwd`."""
    class SSMScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, a, b, c, h0):
            ctx.save_for_backward(x, dt, a, b, c, h0)
            return forward(x, dt, a, b, c, h0=h0)

        @staticmethod
        def backward(ctx, dy, dh):
            return ssm_scan_bwd(*ctx.saved_tensors, dy, dh)
    return SSMScan


def wkv6_function(forward):
    """A ``torch.autograd.Function`` for B5 around ``forward`` (the
    kernel's signature): ``.apply(r, k, v, w, u, state)`` -> (y,
    state_final); its backward is :func:`wkv6_bwd`."""
    class WKV6(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, w, u, state):
            ctx.save_for_backward(r, k, v, w, u, state)
            return forward(r, k, v, w, u, state=state)

        @staticmethod
        def backward(ctx, dy, dstate):
            return wkv6_bwd(*ctx.saved_tensors, dy, dstate)
    return WKV6


FlashAttention = flash_attention_function(flash_attention_cuda)
SSMScan = ssm_scan_function(ssm_scan_cuda)
WKV6 = wkv6_function(wkv6_cuda)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    q_offset=0):
    """q [B, Sq, H, D], k/v [B, Skv, KV, D] -> [B, Sq, H, D]."""
    fn = _route("attention", q, flash_attention_cuda,
                flash_attention_plain)
    if fn is flash_attention_cuda and needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, scale,
                                    q_offset)
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
    if fn is ssm_scan_cuda and needs_grad(x, dt, a, b, c, h0):
        return SSMScan.apply(x, dt, a, b, c, h0)
    return fn(x, dt, a, b, c, h0=h0)


def wkv6(r, k, v, w, u, *, state=None):
    """r/k/v/w [B,S,H,D], u [H,D] -> (y [B,S,H,D], state [B,H,D,D] f32)."""
    fn = _route("wkv6", r, wkv6_cuda, wkv6_plain)
    if fn is wkv6_cuda and needs_grad(r, k, v, w, u, state):
        return WKV6.apply(r, k, v, w, u, state)
    return fn(r, k, v, w, u, state=state)
