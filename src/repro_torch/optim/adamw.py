"""AdamW with decoupled weight decay and global-norm clipping; port of
``repro.optim.adamw``.

State per leaf: f32 (m, v).  Master weights stay in the params tree at
whatever dtype the model was initialised with; updates are computed in
f32 and cast back (bf16-param training keeps f32 moments).  The update
is elementwise, so the port's per-layer leaves give the reference's
numbers for its stacked ones; only :func:`global_norm`'s order of
summation differs.  Functional, as the reference: new params and a new
state, the inputs untouched.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._tree import tree_leaves, tree_map, unzip


class AdamWState(NamedTuple):
    step: torch.Tensor      # i32 scalar
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(params, grads, state: AdamWState, *,
                 lr: float | torch.Tensor = 1e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01,
                 clip_norm: float | None = 1.0):
    step = state.step + 1
    scale = None
    if clip_norm is not None:
        gn = global_norm(grads)
        scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)

    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def upd(p, g, m, v):
        # the clipped f32 grad a leaf at a time: no f32 copy of every grad
        g = g.float() if scale is None else g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh, vh = m / bc1, v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.m, state.v)
    new_params, new_m, new_v = unzip(params, out, 3)
    return new_params, AdamWState(step=step, m=new_m, v=new_v)
