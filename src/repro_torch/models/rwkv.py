"""RWKV6 "Finch" block: attention-free time mixing with data-dependent
decay, and channel mixing; port of ``repro.models.rwkv``.

The reference's simplifications are carried as they are, not moved
toward upstream RWKV: the token-shift mixes are per-channel ``mu`` (no
LoRA mixers), the decay is one dense projection plus ``decay_base``,
``ln_x`` is one LayerNorm over all of d (not a GroupNorm per head), and
``w`` is cast to the compute dtype before the WKV recurrence.  The
recurrence is ``kernels.ops.wkv6`` (kernel B5) at prefill and at every
decode step (S = 1), as the reference's ``time_mix`` calls it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import _dtype, dense, dense_init, norm, norm_init


class RWKVCache(NamedTuple):
    last_x_tm: torch.Tensor   # [B, D] last token input (time mix shift)
    last_x_cm: torch.Tensor   # [B, D] last token input (channel mix shift)
    state: torch.Tensor       # [B, H, Dh, Dh] WKV state (f32)


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    head_dim = 64
    return cfg.d_model // head_dim, head_dim


def rwkv_init(gen, cfg: ModelConfig, *, device="cpu") -> dict:
    d = cfg.d_model
    h, hd = _heads(cfg)
    dt = _dtype(cfg.dtype)
    f32 = dict(dtype=torch.float32, device=device)

    def lin(d_in, d_out):
        return dense_init(gen, d_in, d_out, cfg.dtype, device=device)
    return {
        "mu": torch.full((5, d), 0.5, dtype=dt, device=device),  # r,k,v,g,w
        "wr": lin(d, d),
        "wk": lin(d, d),
        "wv": lin(d, d),
        "wg": lin(d, d),
        "wd": lin(d, d),                                     # decay
        "decay_base": torch.full((d,), -6.0, **f32),
        "u": torch.zeros(h, hd, **f32),
        "ln_x": norm_init(d, "layernorm", "float32", device=device),
        "wo": lin(d, d),
        # channel mix
        "mu_c": torch.full((2, d), 0.5, dtype=dt, device=device),
        "ck": lin(d, cfg.d_ff),
        "cv": lin(cfg.d_ff, d),
        "cr": lin(d, d),
    }


def _shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or the cache, before the first
    token).  x [B,S,D]."""
    if last is None:
        last = torch.zeros_like(x[:, 0])
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
             last_x: torch.Tensor | None, state: torch.Tensor | None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RWKV6 time mixing.  x [B,S,D] -> (y, new last_x, new state)."""
    bsz, s, d = x.shape
    h, hd = _heads(cfg)
    xs = _shift(x, last_x)
    mu = p["mu"].to(x.dtype)

    def mix(i):
        return x * mu[i][None, None] + xs * (1 - mu[i][None, None])

    r = dense(p["wr"], mix(0)).reshape(bsz, s, h, hd)
    k = dense(p["wk"], mix(1)).reshape(bsz, s, h, hd)
    v = dense(p["wv"], mix(2)).reshape(bsz, s, h, hd)
    g = F.silu(dense(p["wg"], mix(3)))
    # data-dependent decay (log-log space)
    w = (p["decay_base"][None, None]
         + dense(p["wd"], mix(4)).float()).reshape(bsz, s, h, hd)
    if state is None:
        state = torch.zeros(bsz, h, hd, hd, dtype=torch.float32,
                            device=x.device)
    y, new_state = ops.wkv6(r, k, v, w.to(x.dtype), p["u"], state=state)
    y = norm(p["ln_x"], y.reshape(bsz, s, d), cfg.norm_eps) * g
    return dense(p["wo"], y), x[:, -1], new_state


def channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                last_x: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    xs = _shift(x, last_x)
    mu = p["mu_c"].to(x.dtype)
    xk = x * mu[0][None, None] + xs * (1 - mu[0][None, None])
    xr = x * mu[1][None, None] + xs * (1 - mu[1][None, None])
    k = torch.square(F.relu(dense(p["ck"], xk)))
    return torch.sigmoid(dense(p["cr"], xr)) * dense(p["cv"], k), x[:, -1]


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                    device="cpu") -> RWKVCache:
    h, hd = _heads(cfg)
    return RWKVCache(
        last_x_tm=torch.zeros(batch, cfg.d_model, dtype=dtype,
                              device=device),
        last_x_cm=torch.zeros(batch, cfg.d_model, dtype=dtype,
                              device=device),
        state=torch.zeros(batch, h, hd, hd, dtype=torch.float32,
                          device=device),
    )
