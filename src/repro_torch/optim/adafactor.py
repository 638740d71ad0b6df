"""Adafactor (Shazeer & Stern 2018) with factored second moments; port of
``repro.optim.adafactor``.

The memory-feasible optimizer for the trillion-parameter kimi-k2 config:
the second moment of a [d_in, d_out] matrix is stored as a row vector and
a column vector, and no first moment is kept.

The reference keeps a stack of layers as one leaf with a leading layer
axis; the port keeps a list of per-layer dicts.  Adafactor is not
elementwise: a leaf is factored when it has two axes or more *stacked*
(so a per-layer norm scale ``[D]`` is factored as ``[L, D]``, its column
moment shared by the layers), and the update clip's RMS runs over the
whole stacked leaf.  So the port treats the per-layer leaves of each
list that the reference stacks as one leaf.  The rule needs no config: a
list with no ``None`` entry is a stack of layers, except a hybrid's
``layers`` (the list beside ``shared_attn``), which the reference keeps
as a list of per-layer dicts whether or not an attention position
(``None``) falls in it, as ``checkpoint.convert.stacked_keys`` does; a
stack's entries must share one structure, shapes and dtypes, or the
update raises.  The state's ``vr`` and ``vc`` are kept in the
reference's layout (one stacked tensor a stacked leaf, under the same
``"/"`` keys), so they equal the reference's leaf for leaf.  Factored
moments are small, so stacked ones are built with ``torch.stack``; a
stacked weight's update is computed a layer at a time.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._tree import tree_leaves, tree_map, unzip


class AdafactorState(NamedTuple):
    step: torch.Tensor   # i32 scalar
    vr: Any   # row second moments (or full v for <2D leaves)
    vc: Any   # col second moments (zeros placeholder for <2D leaves)


class _Layers:
    """The per-layer tensors of one stacked leaf (a leaf of the
    reference-layout tree)."""

    def __init__(self, layers):
        self.layers = list(layers)

    @property
    def shape(self):
        return (len(self.layers), *self.layers[0].shape)


def _is_stack(x) -> bool:
    return isinstance(x, list) and len(x) > 0 and \
        all(e is not None for e in x)


def _stacks(parent: dict, key) -> bool:
    """Whether ``parent[key]`` may be a stack: not a hybrid's
    ``layers``, which sits beside its ``shared_attn``."""
    return not (key == "layers" and "shared_attn" in parent)


def _stack(layers, key):
    first = layers[0]
    if isinstance(first, dict):
        if any(not isinstance(lp, dict) or lp.keys() != first.keys()
               for lp in layers):
            raise ValueError(f"{key}: the layers of a stack differ in "
                             "their keys")
        return {k: _stack([lp[k] for lp in layers], f"{key}/{k}")
                for k in first}
    if not isinstance(first, torch.Tensor) or any(
            not isinstance(t, torch.Tensor) or t.shape != first.shape
            or t.dtype != first.dtype for t in layers):
        raise ValueError(f"{key}: the layers of a stack must hold tensors "
                         "of one shape and dtype")
    return _Layers(layers)


def _layout(tree, key="", stack=True):
    """``tree`` in the reference's layout: each stack of layers one
    subtree whose leaves are ``_Layers``."""
    if isinstance(tree, dict):
        return {k: _layout(v, f"{key}/{k}" if key else k, _stacks(tree, k))
                for k, v in tree.items()}
    if stack and _is_stack(tree):
        return _stack(tree, key)
    if isinstance(tree, list):
        return [_layout(v, f"{key}/{i}" if key else str(i))
                for i, v in enumerate(tree)]
    return tree


def _unlayout(lay, like, stack=True):
    """The port's layout of ``lay`` (shaped as ``like``)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unlayout(lay[k], v, _stacks(like, k))
                for k, v in like.items()}
    if stack and _is_stack(like):
        return [_unlayout(tree_map(
            lambda t, i=i: t.layers[i] if isinstance(t, _Layers) else t,
            lay), v) for i, v in enumerate(like)]
    if isinstance(like, list):
        return [_unlayout(lay[i], v) for i, v in enumerate(like)]
    return lay


def _factored(p) -> bool:
    return len(p.shape) >= 2


def _device(params):
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else None


def adafactor_init(params) -> AdafactorState:
    dev = _device(params)

    def vr(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def vc(p):
        shape = (*p.shape[:-2], p.shape[-1]) if _factored(p) else (0,)
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    lay = _layout(params)
    return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          vr=tree_map(vr, lay), vc=tree_map(vc, lay))


def _moments(g, vr, vc, factored, beta, eps):
    """The reference's moment update and unclipped step for one leaf."""
    g = g.float()
    g2 = g * g + eps
    if factored:
        vr = beta * vr + (1 - beta) * g2.mean(dim=-1)
        vc = beta * vc + (1 - beta) * g2.mean(dim=-2)
        denom = (vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                  min=eps))[..., None] * vc[..., None, :]
        return g * torch.rsqrt(torch.clamp(denom, min=eps)), vr, vc
    vr = beta * vr + (1 - beta) * g2
    return g * torch.rsqrt(torch.clamp(vr, min=eps)), vr, vc


def adafactor_update(params, grads, state: AdafactorState, *,
                     lr: float | torch.Tensor = 1e-3, decay: float = 0.8,
                     eps: float = 1e-30, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    step = state.step + 1
    beta = 1.0 - step.float() ** -decay

    def upd(p, g, vr, vc):
        stacked = isinstance(p, _Layers)
        ps = p.layers if stacked else [p]
        gs = g.layers if stacked else [g]
        if stacked and ps[0].ndim >= 2:
            # factored within each layer; the clip's RMS over the stack
            us, vrs, vcs = zip(*(_moments(gl, vr[i], vc[i], True, beta, eps)
                                 for i, gl in enumerate(gs)))
            vr, vc = torch.stack(vrs), torch.stack(vcs)
            ms = sum(torch.sum(u * u) for u in us) / (len(ps) * ps[0].numel())
        else:
            gg = torch.stack([t.float() for t in gs]) if stacked else g
            u, vr, vc = _moments(gg, vr, vc, _factored(p), beta, eps)
            us = list(u) if stacked else [u]
            ms = torch.mean(u * u)
        clip = torch.clamp(torch.sqrt(ms + eps) / clip_threshold, min=1.0)
        new = [(pl.float() - lr * (u / clip)
                - lr * weight_decay * pl.float()).to(pl.dtype)
               for pl, u in zip(ps, us)]
        return (_Layers(new) if stacked else new[0]), vr, vc

    lay = _layout(params)
    out = tree_map(upd, lay, _layout(grads), state.vr, state.vc)
    new, vr, vc = unzip(lay, out, 3)
    return _unlayout(new, params), AdafactorState(step=step, vr=vr, vc=vc)
