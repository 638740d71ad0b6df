"""Mamba2 block (SSD form), used by zamba2's hybrid layers; port of
``repro.models.ssm``.

Per block: in_proj -> (z | x | B | C | dt), a short causal depthwise conv
over (x | B | C), the selective SSM recurrence (``kernels.ops.ssm_scan``,
kernel B4, at prefill; ``ops.ssm_decode_step``, plain torch, a token at a
time), SiLU(z) gating, out_proj.  The recurrent state ``[B, H, N, P]``
(f32) and the conv's last ``W - 1`` inputs are the decode-time cache.
The casts are the reference's: softplus of dt in f32, ``a = -exp(a_log)``,
``d_skip`` cast to y's dtype, SiLU of z in f32 then cast.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import _dtype, _normal, dense, dense_init


class SSMCache(NamedTuple):
    conv: torch.Tensor   # [B, W-1, conv_dim] last conv inputs
    h: torch.Tensor      # [B, H, N, P] recurrent state (f32)


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state * n_heads
    return d_inner, n_heads, conv_dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``), with no threshold as ``F.softplus`` has."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssm_init(gen, cfg: ModelConfig, *, device="cpu") -> dict:
    d = cfg.d_model
    di, nh, conv_dim = _dims(cfg)
    n = cfg.ssm_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # z | x | B(nh*n) | C(nh*n) | dt(nh)
        "in_proj": dense_init(gen, d, 2 * di + 2 * nh * n + nh, cfg.dtype,
                              device=device),
        "conv_w": _normal(gen, (cfg.ssm_conv_width, conv_dim), 0.1,
                          cfg.dtype, device),
        "conv_b": torch.zeros(conv_dim, dtype=_dtype(cfg.dtype),
                              device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "d_skip": torch.ones(nh, **f32),
        "dt_bias": torch.zeros(nh, **f32),
        "out_proj": dense_init(gen, di, d, cfg.dtype, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d, SiLU.  x [B,S,C]; w [W,C]; history
    [B,W-1,C]."""
    width = w.shape[0]
    if history is None:
        history = torch.zeros(x.shape[0], width - 1, x.shape[2],
                              dtype=x.dtype, device=x.device)
    xp = torch.cat([history, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None]
              for i in range(width))
    return F.silu(out + b[None, None])


def _project(cfg: ModelConfig, p: dict, x: torch.Tensor):
    di, nh, _ = _dims(cfg)
    n = cfg.ssm_state
    zxbcdt = dense(p["in_proj"], x)
    return torch.split(zxbcdt, [di, di, 2 * nh * n, nh], dim=-1)


def ssm_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                make_cache: bool = False
                ) -> tuple[torch.Tensor, SSMCache | None]:
    """x: [B, S, D] -> ([B, S, D], cache or None)."""
    bsz, s, _ = x.shape
    di, nh, _ = _dims(cfg)
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    z, xin, bc, dt = _project(cfg, p, x)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xs, b, c = torch.split(conv_out, [di, nh * n, nh * n], dim=-1)
    xs = xs.reshape(bsz, s, nh, hp).contiguous()
    b = b.reshape(bsz, s, nh, n).contiguous()
    c = c.reshape(bsz, s, nh, n).contiguous()
    dtv = softplus(dt.float() + p["dt_bias"]).contiguous()
    a = -torch.exp(p["a_log"])
    y, h = ops.ssm_scan(xs, dtv, a, b, c)
    y = y + xs * p["d_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, s, di) * F.silu(z.float()).to(y.dtype)
    out = dense(p["out_proj"], y)
    cache = None
    if make_cache:
        w = cfg.ssm_conv_width
        hist = conv_in[:, -(w - 1):]
        pad = (w - 1) - hist.shape[1]
        if pad > 0:     # fewer tokens than the conv's history: zeros first
            hist = F.pad(hist, (0, 0, pad, 0))
        cache = SSMCache(conv=hist, h=h)
    return out, cache


def ssm_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
               cache: SSMCache) -> tuple[torch.Tensor, SSMCache]:
    """x: [B, 1, D] -> ([B, 1, D], the new cache)."""
    bsz = x.shape[0]
    di, nh, _ = _dims(cfg)
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    z, xin, bc, dt = _project(cfg, p, x)
    conv_in = torch.cat([xin, bc], dim=-1)               # [B,1,conv_dim]
    hist = cache.conv.to(conv_in.dtype)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                            history=hist)
    new_hist = torch.cat([hist, conv_in], dim=1)[:, 1:]
    xs, b, c = torch.split(conv_out[:, 0], [di, nh * n, nh * n], dim=-1)
    xs = xs.reshape(bsz, nh, hp)
    b = b.reshape(bsz, nh, n)
    c = c.reshape(bsz, nh, n)
    dtv = softplus(dt[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, h = ops.ssm_decode_step(xs, dtv, a, b, c, cache.h)
    y = y + xs * p["d_skip"][None, :, None].to(y.dtype)
    y = y.reshape(bsz, 1, di) * F.silu(z.float()).to(y.dtype)
    return dense(p["out_proj"], y), SSMCache(conv=new_hist, h=h)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device="cpu") -> SSMCache:
    _, nh, conv_dim = _dims(cfg)
    return SSMCache(
        conv=torch.zeros(batch, cfg.ssm_conv_width - 1, conv_dim,
                         dtype=dtype, device=device),
        h=torch.zeros(batch, nh, cfg.ssm_state, cfg.ssm_head_dim,
                      dtype=torch.float32, device=device),
    )
