"""Step functions (train / prefill / decode) and their sharded wrappers;
port of ``repro.launch.steps``.

The raw steps run on the device their tensors lie on.  The sharded
wrappers bind a config, a ``DeviceMesh`` and an input shape into a step
(``make_step_for`` dispatches on the shape's kind), as the reference
binds them into a ``jax.jit`` with in and out shardings.  Each builder
returns ``(fn, example_args)``, the example arguments ``meta`` tensors
of the shape's inputs (``launch.specs``).  ``fn`` takes plain tensors
(each the global value, the same on every rank) or ``DTensor``s on the
mesh, and computes what the raw step computes on the *global* batch,
whatever the mesh:

* **Rows.** The mesh axes that split the batch under ``batch_specs``
  (the data axes, where they divide it) split its rows, and the caches'
  rows: each rank computes only its own rows.  The ranks of one data
  coordinate (across ``"model"``) compute the same rows.
* **Weights.** Each param (and, in training, each optimizer-state leaf)
  is gathered to a plain full tensor just before the compute, FSDP-style
  (``DTensor.full_tensor``).  So the model, and the kernels B2-B5 that
  write through ``data_ptr()``, see plain local tensors only; no
  ``DTensor`` reaches them.  Every rank computes all heads: there is no
  tensor parallelism over ``"model"``.
* **Training.** The loss is the global masked mean: each rank's masked
  sum over the global count of unmasked labels; an MoE layer's
  load-balance loss and router entropy are global too (the step passes
  the split of the rows to ``loss_fn``, which passes it down to
  ``moe.moe_apply``).  The ranks' grads are summed, so every rank
  holds the global grads; the optimizer then updates the full tensors on
  every rank (AdamW clips by the global norm and Adafactor factors and
  clips over whole leaves, so neither may run on shards), and each rank
  keeps its shard of the new params and state.
* **MoE groups.** An MoE layer routes its tokens in groups, each with
  its own capacity (``moe._group_size``).  A split that cuts a group
  would change which pairs are dropped, so a train or prefill step
  refuses it before any launch (a train step already when it is built);
  decode drops nothing and takes any split.

Collectives, over the mesh dims of more than one rank only (on a mesh
of one card the step issues none and moves no tensor):

* all-gather of every param leaf (and, in training, optimizer-state
  leaf) over the axes that shard it: the data axes (training's FSDP)
  and ``"model"``;
* decode: all-gather over ``"model"`` of the caches' head (or sequence,
  or head-dim) shards, and over the data axes where a cache's rows are
  not split as the batch's;
* training: all-reduce (sum) over the axes that split the rows, of the
  count of unmasked labels, of each MoE layer's expert choice counts
  (twice with ``remat``), of every grad leaf and of the three metrics.

Outputs are placed by slicing each rank's full result, with no
collective: new params and optimizer state under ``param_specs(...,
"train")`` and ``opt_state_specs``; decode's caches under
``cache_specs``; logits, and prefill's caches, split by rows as the
batch.  Metrics are plain replicated scalars.  Each leaf's placement is
worked out once a step function (``_Placer``), so that the host's cost
of the edge stays small beside the step's; on a mesh of one card it
wraps each tensor as it is.  The reference donates
params and optimizer state (train) and caches (decode); here the step
keeps no reference to its inputs, so a caller that drops them frees
them.
"""
from __future__ import annotations

import math

import torch

from .._tree import flatten, map_with_keys, tree_leaves, tree_map, \
    tree_unflatten
from ..models import decode_step as model_decode
from ..models import loss_fn, partitioning, prefill as model_prefill
from ..models.config import InputShape, ModelConfig
from ..models.moe import _group_size
from ..models.sharding import (P, batch_specs, cache_specs, data_axes,
                               opt_state_specs, param_specs, placements)
from ..optim import Optimizer, get_optimizer
from . import specs as S


# ---------------------------------------------------------------------------
# raw steps
# ---------------------------------------------------------------------------

def train_step(cfg: ModelConfig, optimizer: Optimizer, params, opt_state,
               batch, *, remat: bool = True):
    """One step: the loss and the grads of every param leaf (by
    ``torch.autograd.grad``; a leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives it), then ``optimizer.update``.  Returns (new
    params, new optimizer state, metrics), the metrics detached."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        total, metrics = loss_fn(cfg, live, batch, remat=remat)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])
    del live, leaves
    new_params, new_opt = optimizer.update(params, grads, opt_state)
    return new_params, new_opt, {k: v.detach() for k, v in metrics.items()}


def prefill_step(cfg: ModelConfig, params, batch, *, cache_len: int,
                 window: int | None):
    return model_prefill(cfg, params, batch, cache_len=cache_len,
                         window=window)


def decode_step(cfg: ModelConfig, params, batch, caches, *,
                window: int | None):
    return model_decode(cfg, params, batch, caches, window=window)


def default_optimizer(cfg: ModelConfig) -> Optimizer:
    """Adafactor for the trillion-param MoE (factored second moments are
    the only state that fits), AdamW elsewhere."""
    if cfg.param_count() > 100e9:
        return get_optimizer("adafactor", lr=1e-3)
    return get_optimizer("adamw", lr=3e-4)


# ---------------------------------------------------------------------------
# tensors on the mesh
# ---------------------------------------------------------------------------

def _shard(mesh, spec_tree):
    """The tree of each spec's DTensor placements on ``mesh`` (the
    reference's tree of ``NamedSharding``s)."""
    return map_with_keys(spec_tree, lambda _, s: placements(s, mesh))


def _table(mesh, spec_tree) -> dict:
    """``{key: placements}`` of a spec tree."""
    return {k: placements(s, mesh) for k, s in flatten(spec_tree).items()}


def _moves(mesh, have, want) -> bool:
    """Whether going from placements ``have`` to ``want`` changes a mesh
    dim of more than one rank (else each local tensor stays as it is)."""
    for i, (a, b) in enumerate(zip(have, want)):
        if mesh.size(i) > 1 and a != b:
            return True
    return False


class _Placer:
    """Makes a ``DTensor`` under placements ``want`` from each rank's
    local tensor under ``have`` (default: replicated, every rank the
    global value), as ``DTensor.from_local`` does, for one leaf's tensors
    step after step.  This rank's piece is a slice on each mesh dim of
    more than one rank that ``want`` shards and ``have`` does not (a
    copy where it is smaller than the tensor, so that it keeps no
    reference to the rest).  The slices are found once; the ``DTensor``
    spec is ``from_local``'s at the first call, kept while the piece's
    shape, stride and dtype stay the same, so that later calls skip
    ``from_local``'s autograd wrapping, which costs the host more than
    ten times as much a leaf."""

    def __init__(self, mesh, want, have=None):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        coord = mesh.get_coordinate()
        self.dtensor, self.mesh, self.want = DTensor, mesh, tuple(want)
        self.cuts = []
        for i, w in enumerate(self.want):
            h = Replicate() if have is None else have[i]
            if w == h or mesh.size(i) == 1:
                continue
            if not (isinstance(w, Shard) and isinstance(h, Replicate)):
                raise ValueError(f"{tuple(have)} -> {self.want} is not a "
                                 "slice of each rank's tensor")
            self.cuts.append((mesh.size(i), w.dim, coord[i]))
        self.spec = self.meta = None

    def piece(self, x):
        """This rank's piece of the local tensor ``x``."""
        out = x
        for n, dim, c in self.cuts:
            out = out.chunk(n, dim=dim)[c]
        return out if out.numel() == x.numel() else \
            out.clone(memory_format=torch.contiguous_format)

    def __call__(self, x):
        piece = self.piece(x)
        meta = (piece.shape, piece.stride(), piece.dtype)
        if meta == self.meta and not piece.requires_grad:
            return self.dtensor(piece, self.spec, requires_grad=False)
        out = self.dtensor.from_local(piece, self.mesh, self.want,
                                      run_check=False)
        self.spec, self.meta = out._spec, meta
        return out


class _Placers:
    """One :class:`_Placer` a (leaf key, placements), made at its first
    use and kept with the step."""

    def __init__(self, mesh):
        self.mesh, self.made = mesh, {}

    def __call__(self, key, x, want, have=None):
        placer = self.made.get((key, want, have))
        if placer is None:
            placer = self.made[key, want, have] = _Placer(self.mesh, want,
                                                          have)
        return placer(x)


def _place(x, mesh, want, have=None):
    """A ``DTensor`` under ``want`` from each rank's local ``x`` under
    ``have`` (default: replicated, every rank the global value)."""
    return _Placer(mesh, want, have)(x)


def _full(x):
    """The global value of ``x`` as a plain tensor: a ``DTensor``'s
    gathered (or its local tensor where no dim of more than one rank
    splits it), a plain tensor itself.  The steps call it under
    ``torch.no_grad()``, where ``to_local`` skips autograd's wrapping."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    if not _moves(x.device_mesh, x.placements,
                  (Replicate(),) * x.device_mesh.ndim):
        return x.to_local()
    return x.full_tensor()


def _local(x, mesh, want):
    """This rank's local tensor of ``x`` under placements ``want``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return _Placer(mesh, want).piece(x)
    if _moves(mesh, x.placements, want):
        x = x.redistribute(mesh, want)
    return x.to_local()


class _Rows:
    """How the batch's rows are split on a mesh: the placements of a
    leaf split as the batch is (``Shard(0)`` on the mesh dims of the
    batch spec's leading entry), the mesh dims of more than one rank
    among them, and the count of ranks across those."""

    def __init__(self, mesh, bspecs):
        lead = flatten(bspecs)["tokens"][0]
        self.places = placements(P(lead), mesh)
        axes = () if lead is None else \
            ((lead,) if isinstance(lead, str) else tuple(lead))
        names = list(mesh.mesh_dim_names)
        self.dims = [names.index(a) for a in axes
                     if mesh.size(names.index(a)) > 1]
        self.groups = [mesh.get_group(i) for i in self.dims]
        self.ranks = math.prod(mesh.size(i) for i in self.dims)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the ranks that split the rows."""
        import torch.distributed as dist
        for g in self.groups:
            dist.all_reduce(t, group=g)
        return t


def _check_groups(cfg: ModelConfig, rows: _Rows, batch: int, seq: int):
    """Refuse, before any launch, a split of a train or prefill batch
    that cuts an MoE layer's routing groups."""
    if not cfg.is_moe or rows.ranks == 1 or seq == 1:
        return
    n = batch * seq
    whole = _group_size(n, cfg.n_experts, None)
    part = _group_size(n // rows.ranks, cfg.n_experts, None)
    if whole != part:
        raise ValueError(
            f"{cfg.name}: the mesh splits the batch's {n} tokens over "
            f"{rows.ranks} ranks, {n // rows.ranks} each, which cuts the "
            f"MoE routing groups of {whole} tokens (a rank would route "
            f"groups of {part}, with other capacities); each rank must "
            f"hold whole groups of {whole} tokens")


def _batch_size(batch) -> tuple[int, int]:
    b, s = tuple(batch["tokens"].shape)[:2]
    return b, s


# ---------------------------------------------------------------------------
# sharded wrappers
# ---------------------------------------------------------------------------

def make_sharded_train_step(cfg: ModelConfig, mesh, shape: InputShape,
                            optimizer: Optimizer | None = None, *,
                            remat: bool = True):
    """Returns (fn, example_args): ``fn(params, opt_state, batch)`` ->
    (new params and optimizer state as ``DTensor``s under the train
    param specs and ``opt_state_specs``, metrics as plain scalars); the
    example args are ``meta`` tensors (params, ``optimizer.init`` of
    them, the batch).  ``fn`` keeps no reference to the params and state
    it was given (the reference donates them).

    ``fn(..., place=False)`` returns the new params and state as plain
    tensors instead, each the global value: every rank computes the
    whole update, so they need no collective, and the next step takes
    them as they are.  A loop of steps (``launch.train.run``) keeps them
    so and places nothing on the host."""
    optimizer = optimizer or default_optimizer(cfg)
    pshapes = S.params_shapes_for(cfg)
    pspecs = param_specs(cfg, pshapes, mesh, "train")
    oshapes = optimizer.init(pshapes)
    ospecs = opt_state_specs(pspecs, oshapes, pshapes, mesh)
    bshapes = S.batch_specs_for(cfg, shape)
    bspecs = batch_specs(cfg, bshapes, mesh)
    ptab, otab = _table(mesh, pspecs), _table(mesh, ospecs)
    pplace, oplace = _Placers(mesh), _Placers(mesh)
    rows = _Rows(mesh, bspecs)
    _check_groups(cfg, rows, shape.global_batch, shape.seq_len)

    def fn(params, opt_state, batch, *, place: bool = True):
        _check_groups(cfg, rows, *_batch_size(batch))
        with torch.no_grad():
            params = tree_map(_full, params)
            opt_state = tree_map(_full, opt_state)
            batch = {k: _local(v, mesh, rows.places)
                     for k, v in batch.items()}
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            leaves = tree_leaves(live)
            total, metrics = loss_fn(cfg, live, batch, remat=remat,
                                     rows=rows)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else rows.sum(g)
            for p, g in zip(leaves, grads)])
        del live, leaves, total
        new_params, new_opt = optimizer.update(params, grads, opt_state)
        del params, opt_state, grads
        metrics = {k: rows.sum(v.detach().clone())
                   for k, v in metrics.items()}
        if not place:
            return new_params, new_opt, metrics
        return (map_with_keys(new_params,
                              lambda k, x: pplace(k, x, ptab[k])),
                map_with_keys(new_opt, lambda k, x: oplace(k, x, otab[k])),
                metrics)

    return fn, (pshapes, oshapes, bshapes)


def make_sharded_prefill(cfg: ModelConfig, mesh, shape: InputShape):
    """Returns (fn, example_args): ``fn(params, batch)`` -> (logits,
    caches), both ``DTensor``s split by rows as the batch; the params
    take the ``"serve"`` specs.  The caches hold ``shape.seq_len``
    slots, the prompt may be shorter: ``fn`` checks the MoE routing
    groups of the prompt it is given."""
    window = S.decode_window(cfg, shape) if shape.name == "long_500k" \
        else cfg.sliding_window
    pshapes = S.params_shapes_for(cfg)
    bshapes = S.batch_specs_for(cfg, shape)
    rows = _Rows(mesh, batch_specs(cfg, bshapes, mesh))
    place = _Placers(mesh)

    def fn(params, batch):
        _check_groups(cfg, rows, *_batch_size(batch))
        with torch.no_grad():
            params = tree_map(_full, params)
            batch = {k: _local(v, mesh, rows.places)
                     for k, v in batch.items()}
        logits, caches = prefill_step(cfg, params, batch,
                                      cache_len=shape.seq_len,
                                      window=window)
        del params
        return map_with_keys((logits, caches), lambda k, x: place(
            k, x, rows.places, rows.places))

    return fn, (pshapes, bshapes)


def make_sharded_decode(cfg: ModelConfig, mesh, shape: InputShape, *,
                        seq_shard_cache: bool = False):
    """Returns (fn, example_args): ``fn(params, batch, caches)`` ->
    (logits split by rows as the batch, caches under ``cache_specs``
    with ``seq_shard=seq_shard_cache``), as ``DTensor``s; the params
    take the ``"serve"`` specs.  ``fn`` keeps no reference to the caches
    it was given (the reference donates them)."""
    window = S.decode_window(cfg, shape)
    pshapes = S.params_shapes_for(cfg)
    bshapes = S.batch_specs_for(cfg, shape)
    cshapes = S.cache_specs_for(cfg, shape)
    rows = _Rows(mesh, batch_specs(cfg, bshapes, mesh))
    place = _Placers(mesh)

    def fn(params, batch, caches):
        ctab = _table(mesh, cache_specs(cfg, caches, mesh,
                                        seq_shard=seq_shard_cache))
        with torch.no_grad():
            params = tree_map(_full, params)
            batch = {k: _local(v, mesh, rows.places)
                     for k, v in batch.items()}
            caches = tree_map(lambda x: _local(x, mesh, rows.places),
                              caches)
        logits, caches = decode_step(cfg, params, batch, caches,
                                     window=window)
        del params
        return (place("logits", logits, rows.places, rows.places),
                map_with_keys(caches, lambda k, x: place(
                    k, x, ctab[k], rows.places)))

    return fn, (pshapes, bshapes, cshapes)


def make_step_for(cfg: ModelConfig, mesh, shape: InputShape, *,
                  optimize: bool = False):
    """Dispatch on the input shape kind -> (fn, example ``meta`` args).

    ``optimize=True`` enables the activation constraints and their
    selective remat policy (``partitioning``; on the plain tensors the
    steps compute on, the constraints leave each tensor as it is) and
    shards the decode caches' sequence where their heads do not divide
    ``"model"``; ``False`` disables them."""
    if optimize:
        partitioning.enable(data_axes(mesh), "model")
    else:
        partitioning.disable()
    if shape.kind == "train":
        fn, (p, o, b) = make_sharded_train_step(cfg, mesh, shape)
        return fn, (p, o, b)
    if shape.kind == "prefill":
        fn, (p, b) = make_sharded_prefill(cfg, mesh, shape)
        return fn, (p, b)
    fn, (p, b, c) = make_sharded_decode(cfg, mesh, shape,
                                        seq_shard_cache=optimize)
    return fn, (p, b, c)
