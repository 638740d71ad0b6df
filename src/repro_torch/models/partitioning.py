"""Activation sharding constraints; port of ``repro.models.partitioning``.

The constraints pin activations to (batch -> data axes, feature -> model
axis where contracted against a TP-sharded weight) at layer boundaries,
so that a sharded step gathers weights (FSDP) instead of unsharding the
global batch.  The reference pins them with ``with_sharding_constraint``;
here a ``DTensor`` is redistributed to the constraint's placements on its
own ``device_mesh``, and a plain tensor passes through as it is (no mesh
to place it on).

Constraints are OPT-IN (``enable()``): while off, each returns its
argument itself, so the model code runs as without them.
"""
from __future__ import annotations

from functools import partial

from .sharding import P, placements

_STATE: dict = {"on": False, "data": ("data",), "model": "model",
                "remat_policy": None}


def enable(data_axes=("data",), model_axis="model",
           remat_policy: str | None = "dots_with_no_batch_dims_saveable"):
    """Turn on activation constraints and (optionally) a selective remat
    policy: save projection/MLP matmul outputs instead of recomputing
    them in the backward pass (batched products, such as attention's,
    are recomputed, bounding memory)."""
    if remat_policy is not None and remat_policy not in _POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}; known: "
                         f"{sorted(_POLICIES)}")
    _STATE.update(on=True, data=tuple(data_axes), model=model_axis,
                  remat_policy=remat_policy)


def disable():
    _STATE.update(on=False, remat_policy=None)


def _dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls with no batch dims (``aten.mm``,
    ``aten.addmm``: a ``[..., din] @ [din, dout]`` projection reaches
    one of them), recompute everything else."""
    import torch
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {"dots_with_no_batch_dims_saveable":
             _dots_with_no_batch_dims_saveable}


def remat_policy():
    """The ``context_fn`` for ``torch.utils.checkpoint.checkpoint`` of
    the policy ``enable`` set (a selective-checkpoint context, the
    counterpart of ``jax.checkpoint_policies``), or ``None``."""
    name = _STATE.get("remat_policy")
    if not name:
        return None
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return partial(create_selective_checkpoint_contexts, _POLICIES[name])


def is_enabled() -> bool:
    return _STATE["on"]


def _constrain(x, spec: P):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def hidden(x):
    """[B, S, d_model] (or [B, S, ...]) -> batch over data, rest replicated."""
    if not _STATE["on"]:
        return x
    return _constrain(x, P(_STATE["data"], *([None] * (x.ndim - 1))))


def ffn(x):
    """[B, S, d_ff] -> batch over data, hidden over model (TP-interior)."""
    if not _STATE["on"]:
        return x
    return _constrain(
        x, P(_STATE["data"], *([None] * (x.ndim - 2)), _STATE["model"]))


def heads(x):
    """[B, S, H, hd] -> batch over data, heads over model."""
    if not _STATE["on"]:
        return x
    if x.ndim == 4:
        return _constrain(x, P(_STATE["data"], None, _STATE["model"], None))
    return x


def moe_dispatch(x):
    """[E, G*C, ...] expert buffer -> experts over model, the group-major
    dim over data.  The reference's buffer is [G, E, C, D] and its spec
    ``P(data, model, None, None)``; the port dispatches into [E, G*C, D]
    (``moe.moe_apply``), so the same sharding is ``P(model, data,
    None)``."""
    if not _STATE["on"]:
        return x
    return _constrain(x, P(_STATE["model"], _STATE["data"],
                           *([None] * (x.ndim - 2))))


def moe_tokens(x):
    """[G, S_g, D] grouped tokens -> groups over data."""
    if not _STATE["on"]:
        return x
    return _constrain(x, P(_STATE["data"], *([None] * (x.ndim - 1))))


def logits(x):
    """[B, S, V] -> batch over data, vocab over model."""
    if not _STATE["on"]:
        return x
    return _constrain(
        x, P(_STATE["data"], *([None] * (x.ndim - 2)), _STATE["model"]))
