"""The array namespace ``xp`` that the policy bodies run on, over torch.

A registered policy is one pure function ``fn(xp, ctx)`` written against
numpy's spelling (``repro.core.registry``).  This module gives torch that
spelling, so the bodies are the reference's own text:

* ``xp.float32(1e-6)`` / ``xp.int32(k)`` construct scalars.  They return
  Python numbers rounded through the numpy type, which torch combines
  with a tensor in the tensor's dtype, as JAX does with a weak scalar;
* ``xp.mod`` is ``torch.remainder`` (the sign of the divisor, as numpy);
* ``xp.argmax``/``xp.argmin`` of a bool array cast it to ``uint8`` first
  (torch's ``argmax`` takes no bools) and keep the first-index tie rule;
* ``xp.maximum``/``xp.minimum`` take a Python number on either side,
  and ``xp.clip`` is ``minimum(maximum(a, lo), hi)``, as numpy's;
* ctx arrays are :class:`XTensor`, which adds ``.astype`` and reads
  ``a[i]`` at an index tensor with ``index_select``/``gather``, so that
  reading one node's entry never copies the index to the host.

The lane spelling.  A sweep routes all of its lanes in one pass over the
same bodies: the per-node ctx arrays are then ``[L, N]`` XTensors (one
row a lane), and every operation a body applies to a whole array acts on
the last axis, lane by lane:

* a reduction with no ``axis`` (``xp.sum``, ``xp.argmax``,
  ``xp.argmin``) reduces the last axis and keeps it as size 1, so a
  lane's answer ``[L, 1]`` broadcasts against ``[L, N]`` as a scalar
  does against ``[N]``; ``xp.argmax``/``xp.argmin`` keep the first-index
  tie rule;
* ``xp.cumsum`` runs along the last axis;
* ``a[i]`` with a 0-d or ``[L, 1]`` integer index gathers along the last
  axis (a 0-d index, an event's scalar, is the same entry in every lane);
* per-lane scalars come in as ``[L, 1]`` and the event's scalars stay
  0-d (the lanes share the trace).

A 1-D XTensor is the one-lane case without the lane axis: there the
rules read as numpy's (a reduction gives a 0-d tensor, ``a[i]`` a 0-d
entry).  A plain tensor keeps numpy's whole-array semantics.
"""
from __future__ import annotations

import numpy as np
import torch


class _Scalar:
    """A numpy scalar type usable both as a constructor and a dtype."""

    def __init__(self, np_type, torch_dtype, py_type):
        self.np_type, self.torch, self.py_type = np_type, torch_dtype, py_type

    def __call__(self, value):
        return self.py_type(self.np_type(value))


float32 = _Scalar(np.float32, torch.float32, float)
int32 = _Scalar(np.int32, torch.int32, int)
inf = float("inf")


def _dtype(dtype) -> torch.dtype:
    return dtype.torch if isinstance(dtype, _Scalar) else dtype


class XTensor(torch.Tensor):
    """``torch.Tensor`` with the numpy spellings the policy bodies use.

    Results of torch ops on an ``XTensor`` are ``XTensor`` again, so a
    body can chain ``(a & b).astype(xp.int32)``.  Callers turn a policy's
    answer back into a plain tensor with ``.as_subclass(torch.Tensor)``."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        # torch's default, minus its generality: the routing step runs
        # ~100 ops an event through here
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **(kwargs or {}))
        return out.as_subclass(cls) if type(out) is torch.Tensor else out

    def astype(self, dtype):
        return self.to(_dtype(dtype))

    def __getitem__(self, idx):
        if (isinstance(idx, torch.Tensor) and not idx.is_floating_point()
                and idx.dtype != torch.bool):
            if idx.ndim == 0:
                out = self.index_select(-1, idx.reshape(1))
                return out.reshape(()) if self.ndim == 1 else out
            if idx.ndim == self.ndim:       # [L, 1] index into [L, N]
                return self.gather(-1, idx.to(torch.int64))
        return super().__getitem__(idx)


def asx(t: torch.Tensor) -> XTensor:
    """View a tensor as an :class:`XTensor` (no copy)."""
    return t.as_subclass(XTensor)


def where(cond, a, b):
    return torch.where(cond, a, b)


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def maximum(a, b):
    if _number(b):
        return torch.clamp_min(a, b)
    if _number(a):
        return torch.clamp_min(b, a)
    return torch.maximum(a, b)


def minimum(a, b):
    if _number(b):
        return torch.clamp_max(a, b)
    if _number(a):
        return torch.clamp_max(b, a)
    return torch.minimum(a, b)


def clip(a, lo, hi):
    return minimum(maximum(a, lo), hi)


def floor(x):
    return torch.floor(x)


def mod(a, b):
    return torch.remainder(a, b)


# Reductions, as the policy bodies use them: over the whole array (of an
# XTensor: its last axis, lane by lane), or along one axis (the resize
# bodies' ``axis=-1, keepdims=True``).

def _lanes(x) -> bool:
    """Whether ``x`` reduces lane by lane (an XTensor)."""
    return isinstance(x, XTensor)


def sum(x, axis=None, keepdims=False):  # noqa: A001 (numpy's name)
    if axis is None:
        if _lanes(x):
            return torch.sum(x, -1, keepdim=x.ndim > 1)
        return torch.sum(x)
    return torch.sum(x, dim=axis, keepdim=keepdims)


def cumsum(x):
    if _lanes(x):
        return torch.cumsum(x, -1)
    return torch.cumsum(x.reshape(-1), 0)


def _arg(fn, x):
    x = x.to(torch.uint8) if x.dtype == torch.bool else x
    if _lanes(x):
        return fn(x, -1, keepdim=x.ndim > 1)
    return fn(x)


def argmax(x):
    return _arg(torch.argmax, x)


def argmin(x):
    return _arg(torch.argmin, x)
