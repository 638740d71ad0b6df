"""The port's sharding rules, input specs, meshes and activation
constraints against the JAX reference, on the CPU.

Every shape is built by both packages without allocating (the port's
``meta`` tensors, the reference's ``jax.eval_shape``).  The port keeps
its layers as lists of per-layer dicts and its caches as a list a layer
where the reference stacks them, so a port leaf inside a stack is held to
the reference's stacked leaf without its leading layer dim, and every
reference leaf must be used once a layer (``per_layer``).  Params are
held for all ten configs in both modes on the two production meshes and
one where "model" divides few dims; optimizer state for AdamW and
Adafactor (whose ``vr``/``vc`` keep the reference's stacked layout);
batches for every input shape and caches for every decode shape, with
``seq_shard`` off and on.  Then the specs against DTensor placements,
both ways, and on real ``DeviceMesh``es of 16 x 16 and 2 x 16 x 16 under
torch's fake process group (one process); the meshes; the constraints
(off: each returns its argument itself; on: a ``DTensor`` takes the
placements of the reference's spec); the selective remat policy; and
``chip_smoke.GOLDEN_SPECS`` against the reference.  The reference is
imported inside a fixture, so the file also collects where JAX is
absent.
"""
import contextlib
import dataclasses
import functools
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch._tree import flatten
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import (CHIPS_MULTI_POD, CHIPS_SINGLE_POD,
                                make_host_mesh, make_production_mesh)
from repro_torch.launch import specs as S
from repro_torch.models import forward_train, init_params, loss_fn
from repro_torch.models import partitioning
from repro_torch.models import sharding as SH
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.sharding import P, placements, spec_from_placements
from repro_torch.optim import adafactor_init, adamw_init


class FakeMesh:
    """Just enough mesh surface for spec construction."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          "4x3": FakeMesh({"data": 4, "model": 3})}
MODES = ("train", "serve")
DECODE_SHAPES = [s for s in INPUT_SHAPES.values() if s.kind == "decode"]


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax

    import repro.launch.specs as specs
    import repro.models.partitioning as part
    import repro.models.sharding as sh
    import repro.optim as optim
    from repro.configs import get_config as ref_config
    from repro.launch import mesh
    shapes = {}

    def params(arch):
        if arch not in shapes:
            shapes[arch] = specs.params_shapes_for(ref_config(arch))
        return shapes[arch]
    return SimpleNamespace(jax=jax, specs=specs, sh=sh, part=part,
                           optim=optim, mesh=mesh, config=ref_config,
                           params=params)


@functools.cache
def port_params(arch):
    return S.params_shapes_for(get_config(arch))


def ref_flat(ref, tree) -> dict:
    """``{key: leaf}`` of a reference tree, a ``PartitionSpec`` a leaf
    and a spec's entries as a tuple."""
    from jax.sharding import PartitionSpec
    leaves = ref.jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {ref.sh._key_path(path): tuple(v) if isinstance(
        v, PartitionSpec) else tuple(v.shape) for path, v in leaves}


def port_flat(tree) -> dict:
    return {k: tuple(v) for k, v in flatten(tree).items()}


def per_layer(port_keys, ref_specs: dict, ref_shapes: dict) -> dict:
    """The reference's specs on the port's keys.  A key the reference has
    as it is (outside a stack, a hybrid's layers, Adafactor's stacked
    moments) takes its spec; a key inside a stack (found with its layer
    index dropped) the stacked spec without its leading layer dim.
    Every reference leaf must be used, a stacked one once a layer."""
    out, used = {}, Counter()
    for k in port_keys:
        if k in ref_specs:
            out[k] = ref_specs[k]
            used[k] += 1
            continue
        stacked = "/".join(p for p in k.split("/") if not p.isdigit())
        assert stacked in ref_specs, f"{k}: no reference leaf"
        assert ref_specs[stacked][0] is None, (stacked, ref_specs[stacked])
        out[k] = ref_specs[stacked][1:]
        used[stacked] += 1
    for k, shape in ref_shapes.items():
        want = 1 if k in out else shape[0]
        assert used[k] == want, f"{k}: used {used[k]} times, want {want}"
    return out


# ---------------------------------------------------------------------------
# the rules, leaf for leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(ref, arch, mesh):
    cfg, rcfg, m = get_config(arch), ref.config(arch), MESHES[mesh]
    shapes = ref_flat(ref, ref.params(arch))
    for mode in MODES:
        got = port_flat(SH.param_specs(cfg, port_params(arch), m, mode))
        want = per_layer(got, ref_flat(ref, ref.sh.param_specs(
            rcfg, ref.params(arch), m, mode)), shapes)
        assert got == want, [k for k in got if got[k] != want[k]][:5]
    if cfg.is_moe:                          # experts over "model"
        assert got["layers/0/moe/gate"][0] == ("model" if cfg.n_experts
                                               % m.shape["model"] == 0
                                               else None)


OPTIMIZERS = {"adamw": ("adamw_init", adamw_init),
              "adafactor": ("adafactor_init", adafactor_init)}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("arch", ["glm4-9b", "kimi-k2-1t-a32b",
                                  "zamba2-1.2b", "whisper-medium"])
def test_opt_state_specs_match_the_reference(ref, arch, opt):
    """AdamW's m/v per layer as the params; Adafactor's vr/vc stacked
    as the reference's, under the reference's keys."""
    cfg, rcfg = get_config(arch), ref.config(arch)
    ref_init, port_init = OPTIMIZERS[opt]
    rstate = ref.jax.eval_shape(getattr(ref.optim, ref_init),
                                ref.params(arch))
    state = port_init(port_params(arch))
    shapes = ref_flat(ref, rstate)
    tables = {}
    for name, mesh in MESHES.items():
        for mode in MODES:
            pspecs = SH.param_specs(cfg, port_params(arch), mesh, mode)
            got = port_flat(SH.opt_state_specs(pspecs, state,
                                               port_params(arch), mesh))
            want = per_layer(got, ref_flat(ref, ref.sh.opt_state_specs(
                ref.sh.param_specs(rcfg, ref.params(arch), mesh, mode),
                rstate, ref.params(arch), mesh)), shapes)
            assert got == want, [k for k in got if got[k] != want[k]][:5]
            tables[mode, name] = got
    if opt == "adafactor" and cfg.arch_type != "hybrid":
        # the stacked row moments sit under the reference's keys, their
        # rows over the data axes in training (not all None)
        key = "vr/dec_layers/attn/wq/w" if cfg.is_encoder_decoder \
            else "vr/layers/attn/wq/w"
        assert tables["train", "16x16"][key] == (None, "data")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_the_reference(ref, arch):
    cfg, rcfg = get_config(arch), ref.config(arch)
    for shape in INPUT_SHAPES.values():
        assert S.decode_window(cfg, shape) == \
            ref.specs.decode_window(rcfg, shape)
        assert S.describe(cfg, shape) == ref.specs.describe(rcfg, shape)
        batch, rbatch = S.batch_specs_for(cfg, shape), \
            ref.specs.batch_specs_for(rcfg, shape)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in batch.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in rbatch.items()}
        assert all(v.device.type == "meta" for v in batch.values())
        for mesh in MESHES.values():
            for shard_batch in (True, False):
                assert port_flat(SH.batch_specs(
                    cfg, batch, mesh, shard_batch=shard_batch)) == \
                    ref_flat(ref, ref.sh.batch_specs(
                        rcfg, rbatch, mesh, shard_batch=shard_batch))
    for shape in DECODE_SHAPES:
        caches = S.cache_specs_for(cfg, shape)
        rcaches = ref.specs.cache_specs_for(rcfg, shape)
        shapes = ref_flat(ref, rcaches)
        assert all(t.device.type == "meta" for t in flatten(caches).values())
        for mesh in MESHES.values():
            for seq_shard in (False, True):
                got = port_flat(SH.cache_specs(cfg, caches, mesh,
                                               seq_shard=seq_shard))
                want = per_layer(got, ref_flat(ref, ref.sh.cache_specs(
                    rcfg, rcaches, mesh, seq_shard=seq_shard)), shapes)
                assert got == want, [k for k in got if got[k] != want[k]][:5]
    with pytest.raises(ValueError, match="decode"):
        S.cache_specs_for(cfg, INPUT_SHAPES["train_4k"])


# ---------------------------------------------------------------------------
# specs <-> placements, on stand-ins and on real DeviceMeshes
# ---------------------------------------------------------------------------

def all_specs(mesh) -> set:
    """(spec, shape) of every param leaf of every config in both modes,
    every batch leaf and every decode cache leaf, on ``mesh``."""
    out = set()
    for arch in ARCH_IDS:
        cfg, shapes = get_config(arch), flatten(port_params(arch))
        for mode in MODES:
            specs = flatten(SH.param_specs(cfg, port_params(arch), mesh,
                                           mode))
            out |= {(specs[k], tuple(v.shape)) for k, v in shapes.items()}
        for shape in DECODE_SHAPES:
            caches = flatten(S.cache_specs_for(cfg, shape))
            specs = flatten(SH.cache_specs(cfg, S.cache_specs_for(cfg, shape),
                                           mesh, seq_shard=True))
            out |= {(specs[k], tuple(v.shape)) for k, v in caches.items()}
        batch = S.batch_specs_for(cfg, INPUT_SHAPES["train_4k"])
        specs = flatten(SH.batch_specs(cfg, batch, mesh))
        out |= {(specs[k], tuple(v.shape)) for k, v in batch.items()}
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_placements_round_trip(mesh):
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES[mesh]
    pairs = all_specs(m)
    assert any(any(isinstance(e, tuple) for e in s) for s, _ in pairs) \
        == (mesh == "2x16x16")
    for spec, shape in pairs:
        pl = placements(spec, m)
        assert len(pl) == len(m.axis_names)
        assert all(isinstance(p, (Shard, Replicate)) for p in pl)
        assert spec_from_placements(pl, m, len(shape)) == spec
        assert placements(spec_from_placements(pl, m, len(shape)), m) == pl


def test_placements_of_a_spec_and_their_refusals():
    from torch.distributed.tensor import Replicate, Shard
    pod = MESHES["2x16x16"]
    assert placements(P(("pod", "data"), None, "model"), pod) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, ("data",)), pod) == \
        (Replicate(), Shard(1), Replicate())
    assert P(("data",), ()) == P("data", None)
    assert spec_from_placements((Replicate(), Shard(-1), Shard(0)), pod,
                                2) == P("model", "data")
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), pod)
    with pytest.raises(ValueError, match="not in the mesh"):
        placements(P("expert"), pod)
    with pytest.raises(ValueError, match="shards two dims"):
        placements(P("model", "model"), pod)
    with pytest.raises(ValueError, match="placements for a mesh"):
        spec_from_placements((Replicate(),), pod, 1)


@contextlib.contextmanager
def fake_group(world: int):
    """torch's fake process group of ``world`` ranks in this one
    process (collectives do nothing), destroyed on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def meta_dtensor(shape, mesh, pl):
    """A ``DTensor`` of global ``shape`` on ``mesh`` under ``pl``, on
    ``meta``, from its local shard's shape."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, device="meta"), mesh, pl,
                              shape=torch.Size(shape), stride=stride,
                              run_check=False)


def ref_constraint_specs(ref, monkeypatch, da) -> dict:
    """The reference's constraint specs (its ``_constrain`` patched to
    hand back the spec) for ``data_axes`` ``da``."""
    monkeypatch.setattr(ref.part, "_constrain", lambda x, spec: spec)
    ref.part.enable(da, "model")
    try:
        return {name: tuple(getattr(ref.part, name)(np.zeros(shape)))
                for name, shape in CONSTRAINT_SHAPES.items()}
    finally:
        ref.part.disable()


#: A shape each constraint takes; the reference's ``moe_dispatch``
#: buffer is [G, E, C, D], the port's [E, G*C, D].
CONSTRAINT_SHAPES = {"hidden": (32, 8, 64), "ffn": (32, 8, 64),
                     "heads": (32, 8, 32, 16), "moe_tokens": (32, 16, 64),
                     "logits": (32, 8, 64), "moe_dispatch": (32, 16, 4, 64)}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_dtensors_and_constraints(ref, monkeypatch,
                                                  multi_pod):
    """Under a fake group of 256 (512) ranks: ``make_production_mesh``
    gives the reference's shape and names; the rules on the real
    ``DeviceMesh`` equal those on the stand-in; a ``DTensor`` built on
    each spec's placements reports them (and the spec back); each
    constraint, on, redistributes a replicated ``DTensor`` to the
    placements of the reference's spec."""
    from torch.distributed.tensor import Replicate
    name = "2x16x16" if multi_pod else "16x16"
    stand_in = MESHES[name]
    world = CHIPS_MULTI_POD if multi_pod else CHIPS_SINGLE_POD
    assert world == getattr(ref.mesh, "CHIPS_MULTI_POD" if multi_pod
                            else "CHIPS_SINGLE_POD")
    with fake_group(world):
        with pytest.raises(RuntimeError, match="process group"):
            make_production_mesh(multi_pod=not multi_pod, device="cpu")
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert mesh.mesh_dim_names == stand_in.axis_names
        assert tuple(mesh.shape) == tuple(stand_in.shape.values())
        for arch in ("kimi-k2-1t-a32b", "zamba2-1.2b"):
            cfg = get_config(arch)
            for mode in MODES:
                assert port_flat(SH.param_specs(
                    cfg, port_params(arch), mesh, mode)) == port_flat(
                    SH.param_specs(cfg, port_params(arch), stand_in, mode))
        for spec, shape in all_specs(stand_in):
            pl = placements(spec, mesh)
            d = meta_dtensor(shape, mesh, pl)
            assert tuple(d.placements) == pl and tuple(d.shape) == shape
            assert spec_from_placements(d.placements, mesh,
                                        len(shape)) == spec

        ref_specs = ref_constraint_specs(ref, monkeypatch,
                                         SH.data_axes(stand_in))
        partitioning.enable(SH.data_axes(mesh), "model")
        try:
            for fn, shape in CONSTRAINT_SHAPES.items():
                want = P(*ref_specs[fn])
                if fn == "moe_dispatch":     # [G, E, C, D] -> [E, G*C, D]
                    g, e, c, d = shape
                    shape = (e, g * c, d)
                    want = P(want[1], want[0], want[3])
                x = meta_dtensor(shape, mesh, (Replicate(),) * mesh.ndim)
                y = getattr(partitioning, fn)(x)
                assert tuple(y.placements) == placements(want, mesh), fn
        finally:
            partitioning.disable()


def test_host_mesh_on_the_cpu():
    """No process group: ``make_host_mesh`` sets up one of world size 1
    over ``gloo`` and gives a (1, 1) ("data", "model") mesh; without
    ``device`` it wants the card and never falls back to the CPU."""
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.device_type == "cpu"
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert SH.data_axes(mesh) == ("data",)
        assert SH.model_axis_size(mesh) == 1
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="not been set up"):
        make_production_mesh(device="cpu")
    if not torch.cuda.is_available():       # the card or a raise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_host_mesh()
        assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the constraints in the model code, and the remat policy
# ---------------------------------------------------------------------------

CONSTRAINTS = ("hidden", "ffn", "heads", "moe_dispatch", "moe_tokens",
               "logits")


def test_constraints_return_a_plain_tensor_itself():
    x = torch.zeros(2, 3, 4, 5)
    assert not partitioning.is_enabled()
    assert partitioning.remat_policy() is None
    for name in CONSTRAINTS:
        assert getattr(partitioning, name)(x) is x
    partitioning.enable(("pod", "data"), "model")
    try:
        assert partitioning.is_enabled()
        assert callable(partitioning.remat_policy())
        for name in CONSTRAINTS:              # no mesh to place it on
            assert getattr(partitioning, name)(x) is x
    finally:
        partitioning.disable()
    assert not partitioning.is_enabled()
    with pytest.raises(ValueError, match="remat policy"):
        partitioning.enable(remat_policy="nothing_saveable")
    assert not partitioning.is_enabled()


def test_remat_policy_saves_the_unbatched_dots():
    from torch.utils.checkpoint import CheckpointPolicy
    partitioning.enable()
    try:
        policy = partitioning.remat_policy().args[0]
    finally:
        partitioning.disable()
    aten = torch.ops.aten
    for op, want in ((aten.mm.default, CheckpointPolicy.MUST_SAVE),
                     (aten.addmm.default, CheckpointPolicy.MUST_SAVE),
                     (aten.bmm.default, CheckpointPolicy.PREFER_RECOMPUTE),
                     (aten.mul.Tensor, CheckpointPolicy.PREFER_RECOMPUTE)):
        assert policy(None, op) == want, op


def reduced(arch):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=2)


def small_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                            .astype(np.int32))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    return {"tokens": toks, "positions": pos, "seq_positions": pos,
            "labels": toks}


@pytest.mark.parametrize("arch", ["glm4-9b", "granite-moe-1b-a400m",
                                  "zamba2-1.2b", "rwkv6-7b"])
def test_constraints_on_leave_the_model_and_its_grads_unchanged(arch):
    """With the constraints on, plain tensors pass every call site as
    they are: the forward is bitwise the same; and ``remat`` with the
    selective policy gives the gradients of plain ``remat``."""
    cfg = reduced(arch)
    params = init_params(cfg, 0, device="cpu")
    batch = small_batch(cfg)
    want, _ = forward_train(cfg, params, batch, remat=False)

    def grads():
        leaves = [t.requires_grad_() for t in flatten(params).values()
                  if t.is_floating_point()]
        loss, _ = loss_fn(cfg, params, batch, remat=True)
        out = torch.autograd.grad(loss, leaves, allow_unused=True)
        for t in leaves:
            t.requires_grad_(False)
        return loss.detach(), out
    loss0, g0 = grads()
    partitioning.enable(("data",), "model")
    try:
        got, _ = forward_train(cfg, params, batch, remat=False)
        loss1, g1 = grads()
    finally:
        partitioning.disable()
    assert torch.equal(got, want)
    assert torch.equal(loss1, loss0)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# the card's golden
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_golden_specs_are_the_references(ref, arch):
    """``chip_smoke.GOLDEN_SPECS`` (the card, which has no JAX, holds the
    port's rules to it) is the digest of the reference's param specs
    laid out per layer, and the port's own tables give it too."""
    from test_torch_sim import _chip_smoke
    smoke = _chip_smoke()
    cfg, rcfg = get_config(arch), ref.config(arch)
    shapes = ref_flat(ref, ref.params(arch))
    port = smoke.spec_tables(cfg)
    want = {}
    for name, mesh in smoke.SPEC_MESHES.items():
        for mode in smoke.SPEC_MODES:
            key = f"{mode}/{name}"
            table = per_layer(port[key], ref_flat(ref, ref.sh.param_specs(
                rcfg, ref.params(arch), smoke.MeshShape(mesh), mode)),
                shapes)
            want[key] = smoke.spec_digest(table)
    assert smoke.GOLDEN_SPECS[arch] == want
    assert smoke.golden_misses(arch, port) == []
