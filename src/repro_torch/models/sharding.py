"""Sharding rules: partition specs for params, optimizer state, batches
and caches, per (mesh, mode); port of ``repro.models.sharding``.

Conventions (as the reference's):

* TRAIN — FSDP + TP: 2-D weights shard (in_dim -> data axes, out_dim ->
  "model") with transposes for output projections; experts shard over
  "model"; batch shards over the data axes.
* SERVE — TP only for weights (replicated over data so each data-parallel
  replica group serves its own requests); request batch + caches shard over
  data; KV heads (or head_dim when kv_heads is too small) shard over
  "model".

Rules are applied by *leaf path name*, one entry a tensor dim, so they
track the param trees built in ``models/`` without a parallel registry.
A spec is a :class:`P` (the reference's ``PartitionSpec``: an entry a
tensor dim, each ``None``, a mesh axis name or a tuple of names);
:func:`placements` turns it into the ``torch.distributed.tensor``
placements on a ``DeviceMesh``, one a mesh dim, and
:func:`spec_from_placements` turns them back.

The rules read only the mesh's axis names and sizes: a torch
``DeviceMesh`` (``mesh_dim_names``, ``size(i)``) or any stand-in with
``axis_names`` and a ``shape`` by name, so that they run at the
production shape with no process group.

The port keeps each stack of layers as a list of per-layer dicts, and
its caches as a list with one entry a layer (whisper's ``self_caches``,
``cross_k`` and ``cross_v`` too), where the reference stacks them on a
leading layer axis.  So a per-layer leaf's spec is the reference's for
the stacked leaf without its leading ``None``, and no cache leaf has a
layer axis.  Adafactor's ``vr`` and ``vc`` keep the reference's stacked
layout (``optim/adafactor.py``): :func:`opt_state_specs` maps a stacked
key onto the per-layer param's spec with the leading ``None`` put back.
"""
from __future__ import annotations

import math

from .._tree import flatten, map_with_keys
from ..optim.adafactor import _is_stack, _stacks
from .config import ModelConfig


def _entry(entry):
    """One spelling an entry, as ``PartitionSpec`` makes it: a tuple of
    one name is that name, an empty tuple ``None``."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


class P:
    """A partition spec: one entry a tensor dim, each ``None``
    (replicated), a mesh axis name, or a tuple of names (the dim split
    over those axes, the first the major one), spelled as
    ``jax.sharding.PartitionSpec`` spells them.  Not a tuple, so that
    the port's tree functions (``_tree``) take it as a leaf."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(map(_entry, parts))

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.parts == other.parts

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P({', '.join(map(repr, self.parts))})"


def _axes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a torch DeviceMesh
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {n: mesh.shape[n] for n in mesh.axis_names}


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in _axes(mesh) if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return _axes(mesh)["model"]


def _divides(n: int, d: int) -> bool:
    return d > 0 and n % d == 0


def param_spec_for(key: str, shape: tuple[int, ...], *, mode: str,
                   da: tuple[str, ...], msize: int,
                   stacked: bool = False) -> P:
    """Partition spec for one param leaf.  ``stacked``: leading layer
    dim (the reference's layout; the port's per-layer leaves have
    none)."""
    fs = da if mode == "train" else None   # FSDP axes (train only)
    core = shape[1:] if stacked else shape
    nd = len(core)

    def wrap(*spec):
        spec = list(spec) + [None] * (nd - len(spec))
        if stacked:
            spec = [None] + spec
        return P(*spec)

    leaf = key.split("/")[-1]
    parent = key.split("/")[-2] if "/" in key else ""

    # ---- MoE expert tensors [E, din, dout] (raw tensors: leaf name is
    # the projection name itself) ----
    if leaf in ("gate", "up", "down") and nd == 3:
        return wrap("model", fs, None)
    if parent == "router":
        return wrap(fs, None)

    # ---- biases / norms / small vectors ----
    if leaf in ("g", "b") and nd == 1:
        return wrap(None)
    if leaf in ("a_log", "d_skip", "dt_bias") and nd == 1:
        return wrap("model" if _divides(core[0], msize) else None)
    if leaf == "u":  # rwkv [H, hd]
        return wrap("model" if _divides(core[0], msize) else None, None)
    if leaf in ("mu", "mu_c", "decay_base"):
        return wrap(*([None] * nd))
    if leaf == "conv_w":  # [W, conv_dim]
        return wrap(None, "model" if _divides(core[1], msize) else None)
    if leaf == "conv_b":
        return wrap("model" if _divides(core[0], msize) else None)
    if leaf == "emb":  # [V, D]
        return wrap(fs, "model")
    if leaf == "pos_embed" or parent == "pos_embed" \
            or key.endswith("pos_embed"):
        return wrap(None, None)

    # ---- 2-D projections ----
    if nd == 2:
        din, dout = core
        # output projections contract the sharded ("model") dim
        out_proj = parent in ("wo", "down", "cv", "out_proj")
        if leaf == "w" and out_proj:
            return wrap("model" if _divides(din, msize) else None, fs)
        if leaf == "w":
            return wrap(fs, "model" if _divides(dout, msize) else None)
    if nd == 1 and leaf == "b":
        return wrap(None)
    return wrap(*([None] * nd))


def param_specs(cfg: ModelConfig, params_shapes, mesh, mode: str):
    """Spec tree matching ``params_shapes`` (``init_params(cfg,
    device="meta")``, or the params themselves)."""
    da = data_axes(mesh)
    msize = model_axis_size(mesh)

    def assign(key, leaf):
        spec = param_spec_for(key, tuple(leaf.shape), mode=mode, da=da,
                              msize=msize)
        return _sanitize(spec, leaf.shape, mesh)

    return map_with_keys(params_shapes, assign)


def _sanitize(spec: P, shape, mesh) -> P:
    """Every sharded dim must divide evenly; drop axes that don't
    (replicate that dim instead)."""
    sizes = _axes(mesh)
    out = []
    spec_t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for dim, axes in zip(shape, spec_t):
        if axes is None:
            out.append(None)
            continue
        ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        total = math.prod(sizes[a] for a in ax_tuple)
        out.append(axes if dim % total == 0 else None)
    return P(*out)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, batch_shapes, mesh, *,
                shard_batch: bool = True):
    """Shard the leading (global batch) dim over the data axes."""
    b_axes = data_axes(mesh) if shard_batch else None

    def assign(_key, leaf):
        nd = len(leaf.shape)
        return _sanitize(P(b_axes, *([None] * (nd - 1))), leaf.shape, mesh)

    return map_with_keys(batch_shapes, assign)


def cache_specs(cfg: ModelConfig, cache_shapes, mesh, *,
                shard_batch: bool = True, seq_shard: bool = False):
    """KV caches [B, S, KV, hd] / SSM / RWKV states, one a layer: batch
    -> data, heads -> model when divisible.

    ``seq_shard``: when kv_heads doesn't divide the model axis, shard the
    cache *sequence* dim over "model" instead of head_dim (decode
    attention then partitions ring-attention style instead of contracting
    a sharded head_dim)."""
    msize = model_axis_size(mesh)
    b_axes = data_axes(mesh) if shard_batch else None

    def assign(key, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        # the layer's index in its list is not part of the rules' key
        name = "/".join(p for p in key.split("/") if not p.isdigit())
        leaf_name = name.split("/")[-1]

        def sp(*core):
            return P(*core, *([None] * (nd - len(core))))

        if leaf_name in ("k", "v", "cross_k", "cross_v"):
            # [B, S, KV, hd]
            s_len, kv, hd = shape[1], shape[2], shape[3]
            if _divides(kv, msize):
                return sp(b_axes, None, "model", None)
            if seq_shard and _divides(s_len, msize):
                return sp(b_axes, "model", None, None)
            if _divides(hd, msize):
                return sp(b_axes, None, None, "model")
            return sp(b_axes, None, None, None)
        if leaf_name == "slot_pos":
            if seq_shard and _divides(shape[1], msize):
                return sp(b_axes, "model")
            return sp(b_axes, None)
        if leaf_name == "conv":   # [B, W-1, conv_dim]
            return sp(b_axes, None,
                      "model" if _divides(shape[2], msize) else None)
        if leaf_name in ("h", "state"):  # [B, H, N, P] / rwkv [B, H, hd, hd]
            return sp(b_axes, "model" if _divides(shape[1], msize) else None)
        if leaf_name in ("last_x_tm", "last_x_cm"):  # [B, D]
            return sp(b_axes, "model" if _divides(shape[1], msize) else None)
        return sp(b_axes)

    return map_with_keys(
        cache_shapes,
        lambda key, leaf: _sanitize(assign(key, leaf), leaf.shape, mesh))


def opt_state_specs(pspecs, opt_state_shapes, params_shapes, mesh):
    """Optimizer-state specs derived from param specs: AdamW m/v mirror the
    param spec; Adafactor vr drops the last dim, vc keeps (…, last).
    Adafactor's stacked leaves (``vr/layers/attn/wq/w``) take the
    per-layer param's spec with the layer axis in front."""

    def assign_like(spec: P, pshape, sshape):
        spec_t = tuple(spec) + (None,) * (len(pshape) - len(tuple(spec)))
        if sshape == pshape:
            return P(*spec_t)
        if sshape == pshape[:-1]:           # adafactor vr
            return P(*spec_t[:-1])
        if len(pshape) >= 2 and sshape == (*pshape[:-2], pshape[-1]):  # vc
            return P(*spec_t[:-2], spec_t[-1])
        if sshape == (0,) or len(sshape) == 0:
            return P()
        return P(*([None] * len(sshape)))

    specs = flatten(pspecs)
    pleaves = {key: (specs[key], tuple(leaf.shape))
               for key, leaf in flatten(params_shapes).items()}
    # the lists that Adafactor stacks, as the reference does
    for name, layers in params_shapes.items():
        if not (_is_stack(layers) and _stacks(params_shapes, name)):
            continue
        for sub in flatten(layers[0]):
            spec, shape = pleaves[f"{name}/0/{sub}"]
            pleaves[f"{name}/{sub}"] = (P(None, *spec), (len(layers), *shape))

    def assign(key, leaf):
        shape = tuple(leaf.shape)
        # strip the optimizer-state prefix (m/v/vr/vc) to find the param key
        for prefix in ("m/", "v/", "vr/", "vc/"):
            if key.startswith(prefix):
                pkey = key[len(prefix):]
                if pkey in pleaves:
                    spec, pshape = pleaves[pkey]
                    return _sanitize(assign_like(spec, pshape, shape),
                                     shape, mesh)
        if key == "step":
            return P()
        return P(*([None] * len(shape)))

    return map_with_keys(opt_state_shapes, assign)


# ---------------------------------------------------------------------------
# specs <-> DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` on each mesh dim whose axis shards tensor dim ``d``,
    ``Replicate()`` on the others.  A dim split over several axes (as
    ``("pod", "data")``) is ``Shard(d)`` on each; DTensor splits mesh
    dims left to right, so the axes must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(_axes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: axis {a!r} is not in the mesh's "
                                 f"{tuple(names)}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {tuple(names)}; DTensor splits mesh "
                             "dims left to right")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: axis {names[i]!r} shards two "
                                 "dims")
            out[i] = Shard(d)
    return tuple(out)


def spec_from_placements(places, mesh, ndim: int) -> P:
    """The inverse of :func:`placements`, for a tensor of ``ndim``
    dims."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(_axes(mesh))
    if len(places) != len(names):
        raise ValueError(f"{len(places)} placements for a mesh of "
                         f"{len(names)} dims")
    dims: list = [[] for _ in range(ndim)]
    for name, pl in zip(names, places):
        if isinstance(pl, Shard):
            dims[pl.dim % ndim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} is neither Shard nor "
                             "Replicate")
    return P(*dims)
