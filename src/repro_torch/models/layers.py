"""Primitive layers, port of ``repro.models.layers``.

Functional as in the reference: ``*_init`` returns a params dict of
tensors, and each layer is a plain function of (params, activations).
Inits draw from an explicit ``torch.Generator``; the numbers differ from
the reference's ``jax.random`` ones, so tests carry the reference's
weights across (``repro_torch.checkpoint``) instead of re-initialising.
On ``device="meta"`` an init allocates nothing (shapes and dtypes only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _normal(gen, shape, scale: float, dtype: str, device) -> torch.Tensor:
    """f32 normal draws times ``scale``, cast to ``dtype`` (the
    reference's ``(normal(key, shape, f32) * scale).astype(dtype)``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=_dtype(dtype), device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(_dtype(dtype))


def dense_init(gen, d_in: int, d_out: int, dtype="float32",
               bias: bool = False, scale: float | None = None, *,
               device="cpu") -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=_dtype(dtype), device=device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (+ b), the weight cast to the activation's dtype."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding_init(gen, vocab: int, d: int, dtype="float32", *,
                   device="cpu") -> dict:
    return {"emb": _normal(gen, (vocab, d), d ** -0.5, dtype, device)}


def embed(p: dict, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return p["emb"][ids].to(dtype)


def norm_init(d: int, norm_type: str = "rmsnorm", dtype="float32", *,
              device="cpu") -> dict:
    p = {"g": torch.ones(d, dtype=_dtype(dtype), device=device)}
    if norm_type == "layernorm":
        p["b"] = torch.zeros(d, dtype=_dtype(dtype), device=device)
    return p


def norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm (when ``p`` has a bias) or RMSNorm, in f32 with
    ``rsqrt``, cast back to x's dtype."""
    xf = x.float()
    if "b" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["g"].float() + p["b"].float()
    else:  # rmsnorm
        ms = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["g"].float()
    return y.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu}[name]


def mlp_init(gen, d: int, d_ff: int, act: str = "silu", dtype="float32", *,
             device="cpu") -> dict:
    if act == "silu":  # gated (SwiGLU family)
        return {"gate": dense_init(gen, d, d_ff, dtype, device=device),
                "up": dense_init(gen, d, d_ff, dtype, device=device),
                "down": dense_init(gen, d_ff, d, dtype, device=device)}
    return {"up": dense_init(gen, d, d_ff, dtype, device=device),
            "down": dense_init(gen, d_ff, d, dtype, device=device)}


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    f = act_fn(act)
    if "gate" in p:
        return dense(p["down"], f(dense(p["gate"], x)) * dense(p["up"], x))
    return dense(p["down"], f(dense(p["up"], x)))
