"""The port's sharded steps and dry-run against the raw steps and the JAX
reference, on the CPU.

Four ``gloo`` ranks (spawned processes meeting at a ``file://`` store
under ``tmp_path``) run the sharded train, prefill and decode steps on
``(4, 1)`` and ``(2, 2)`` ``("data", "model")`` meshes, for a reduced
config of a dense model (starcoder2-3b: sliding window, qkv biases), a
hybrid (zamba2-1.2b, with ``remat``) and an MoE (granite-moe-1b-a400m,
its experts widened to 64 so that a routing group is 1,024 tokens and
each rank holds whole groups; with ``remat``, so each MoE layer's
all-reduce runs again in the backward pass).  The batches are uneven on
purpose: masked labels at random and a first row with none, so that the
ranks hold different counts of labels.  The train steps alternate
between outputs placed as ``DTensor``s and kept plain (``place=False``,
the global values).  This process runs the raw steps
on the global batch, and the sharded ones must equal them within
``TOL`` (1e-5) relative L2 in f32: each tree (params, AdamW's moments)
as one vector after ``STEPS`` steps (a single leaf is no yardstick
there: a leaf whose gradient is near zero, as a key bias is, takes
AdamW's normalised step of its noise), the metrics, and logits and
caches of a prefill and ``DECODES`` decode steps.  A split that cuts an
MoE routing group is refused before any launch.  On a ``(1, 1)`` host
mesh the sharded train step equals the reference's sharded step on its
host mesh, with the reference's weights (``params_from_reference``) and
``tests/test_torch_train.py``'s tolerances.  The dry-run runs under
torch's fake process group, its record against sums worked out from the
specs, and as a command with JAX blocked.  The ``cuda``-marked case
runs on the card.  The reference is imported inside fixtures, so the
file also collects where JAX is absent.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch._tree import flatten, tree_map
from repro_torch.configs import get_config
from repro_torch.launch import make_host_mesh
from repro_torch.launch import steps as T
from repro_torch.models import init_params
from repro_torch.models.config import InputShape
from repro_torch.optim import get_optimizer

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = ((4, 1), (2, 2))
STEPS = 3
DECODES = 2
LR = 1e-3
TOL = 1e-5
#: Seconds the ranks may take together before they are stopped.
RANK_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its ops are small, and
    four ranks share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_configs() -> dict:
    """family: (reduced cfg, global batch, sequence, remat)."""
    moe = dataclasses.replace(
        get_config("granite-moe-1b-a400m").reduced(), n_experts=64,
        moe_d_ff=64, d_model=128, n_heads=2, n_kv_heads=2, d_ff=128)
    return {"dense": (get_config("starcoder2-3b").reduced(), 4, 32, False),
            "hybrid": (get_config("zamba2-1.2b").reduced(), 4, 32, True),
            "moe": (moe, 8, 512, True)}


FAMILIES = tuple(family_configs())


def train_batch(cfg, b: int, s: int, seed: int) -> dict:
    """Tokens and labels with ~30% masked, row 0 all masked."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[rng.random((b, s)) < 0.3] = -1
    labels[0] = -1
    pos = torch.from_numpy(
        np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy())
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(labels), "positions": pos,
            "seq_positions": pos}


def serve_batches(cfg, b: int, s: int) -> list:
    """A prompt of ``s`` tokens, then ``DECODES`` one-token batches."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (b, s + DECODES)).astype(np.int32)
    out = []
    for lo, hi in [(0, s)] + [(s + i, s + i + 1) for i in range(DECODES)]:
        pos = torch.arange(lo, hi, dtype=torch.int32)[None].expand(b, -1)
        out.append({"tokens": torch.from_numpy(toks[:, lo:hi].copy()),
                    "positions": pos, "seq_positions": pos})
    return out


def trajectory(cfg, b, s, remat, step_for) -> tuple:
    """``STEPS`` AdamW steps of ``step_for(optimizer)`` from seed 0:
    (full params, full state, metrics of each step)."""
    opt = get_optimizer("adamw", lr=LR)
    params = init_params(cfg, 0, "cpu")
    state = opt.init(params)
    step, metrics = step_for(opt), []
    for i in range(STEPS):
        params, state, m = step(params, state, train_batch(cfg, b, s, i))
        metrics.append({k: float(v) for k, v in m.items()})
    return tree_map(T._full, params), tree_map(T._full, state), metrics


def serving(cfg, b, s, prefill, decode) -> tuple:
    """A prefill and ``DECODES`` decode steps: (logits of each call, the
    last caches), full."""
    params = init_params(cfg, 1, "cpu")
    first, *rest = serve_batches(cfg, b, s)
    logits, caches = prefill(params, first)
    out = [T._full(logits)]
    for batch in rest:
        logits, caches = decode(params, batch, caches)
        out.append(T._full(logits))
    return out, tree_map(T._full, caches)


def alternate(fn):
    """The sharded train step ``fn`` with its outputs placed as
    ``DTensor``s at the first, third, ... call and kept plain
    (``place=False``) at the others, so that a trajectory takes and
    gives both."""
    calls = []

    def step(*args):
        calls.append(None)
        return fn(*args, place=len(calls) % 2 == 1)
    return step


def cache_len(s: int) -> int:
    return s + DECODES + 2


def _ranks(rank: int, store: str, out: str) -> None:
    """One of ``WORLD`` ranks: every family on every mesh through the
    sharded steps; rank 0 saves the full results."""
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=RANK_TIMEOUT))
    try:
        res = {}
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            for fam, (cfg, b, s, remat) in family_configs().items():
                train = trajectory(cfg, b, s, remat, lambda opt: alternate(
                    T.make_sharded_train_step(
                        cfg, mesh, InputShape("train", s, b, "train"), opt,
                        remat=remat)[0]))
                n = cache_len(s)
                prefill, _ = T.make_sharded_prefill(
                    cfg, mesh, InputShape("prefill", n, b, "prefill"))
                decode, _ = T.make_sharded_decode(
                    cfg, mesh, InputShape("decode", n, b, "decode"),
                    seq_shard_cache=shape == (2, 2))
                res[shape, fam] = train, serving(cfg, b, s, prefill, decode)
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The ranks' results: {(mesh, family): (train, serving)}."""
    import multiprocessing as mp
    d = tmp_path_factory.mktemp("ranks")
    store, out = str(d / "store"), str(d / "out.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_ranks, args=(r, store, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join()
    assert not hung, f"{len(hung)} ranks did not finish"
    assert all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return torch.load(out, weights_only=False)


@pytest.fixture(scope="module")
def raw():
    """The raw steps on the global batch: {family: (train, serving)}."""
    out = {}
    for fam, (cfg, b, s, remat) in family_configs().items():
        train = trajectory(cfg, b, s, remat, lambda opt: (
            lambda p, st, batch: T.train_step(cfg, opt, p, st, batch,
                                              remat=remat)))
        n, w = cache_len(s), cfg.sliding_window
        out[fam] = train, serving(
            cfg, b, s,
            lambda p, batch: T.prefill_step(cfg, p, batch, cache_len=n,
                                            window=w),
            lambda p, batch, c: T.decode_step(cfg, p, batch, c, window=w))
    return out


def rel_l2(got: dict, want: dict) -> float:
    """Relative L2 of two flat trees, as one vector each."""
    assert got.keys() == want.keys()
    g = torch.cat([got[k].float().reshape(-1) for k in want])
    w = torch.cat([want[k].float().reshape(-1) for k in want])
    return float((g - w).norm() / w.norm())


MESH_IDS = [f"{a}x{b}" for a, b in MESHES]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_train_step_equals_the_raw_step(sharded, raw, mesh, family):
    (p, s, m), _ = sharded[mesh, family]
    (want_p, want_s, want_m), _ = raw[family]
    assert rel_l2(flatten(p), flatten(want_p)) <= TOL
    for name in ("m", "v"):
        assert rel_l2(flatten(getattr(s, name)),
                      flatten(getattr(want_s, name))) <= TOL, name
    assert int(s.step) == int(want_s.step) == STEPS
    for got, want in zip(m, want_m):
        for k, v in want.items():
            assert abs(got[k] - v) <= TOL * max(abs(v), 1e-6), (k, got, want)
    if family == "moe":
        assert want_m[0]["moe_aux"] > 0 and want_m[0]["router_entropy"] > 0


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_prefill_and_decode_equal_the_raw_steps(sharded, raw, mesh, family):
    _, (logits, caches) = sharded[mesh, family]
    _, (want_logits, want_caches) = raw[family]
    assert len(logits) == DECODES + 1
    for got, want in zip(logits, want_logits):
        assert got.shape == want.shape
        assert rel_l2({"x": got}, {"x": want}) <= TOL
    assert rel_l2(flatten(caches), flatten(want_caches)) <= TOL


@pytest.fixture
def fake_group():
    """torch's fake process group of ``WORLD`` ranks in this process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_split_that_cuts_moe_groups_is_refused(fake_group):
    """At (4, 1) a batch of 4 x 512 gives each rank 512 tokens of a
    1,024-token group: train (when built and when called) and prefill
    (when called) refuse it before any launch; decode (no token
    dropped) takes it."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    cfg, b, s, _ = family_configs()["moe"]
    cut = 4
    with pytest.raises(ValueError, match="groups of 1024 tokens"):
        T.make_sharded_train_step(cfg, mesh, InputShape("t", s, cut,
                                                        "train"))
    fn, (params, state, batch) = T.make_sharded_train_step(
        cfg, mesh, InputShape("t", s, b, "train"))
    small = {k: v[:cut] for k, v in batch.items()}     # meta: no data
    with pytest.raises(ValueError, match="cuts the MoE routing groups"):
        fn(params, state, small)
    pre, (params, batch) = T.make_sharded_prefill(
        cfg, mesh, InputShape("p", s, cut, "prefill"))
    with pytest.raises(ValueError, match="groups of 1024 tokens"):
        pre(params, batch)
    T.make_sharded_decode(cfg, mesh, InputShape("d", s, cut, "decode"))


def test_placements_tree_and_one_rank_mesh():
    """``_shard`` gives each spec's placements; on a (1, 1) mesh a
    DTensor's local tensor is the full one and no leaf is copied."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import specs as S
    from repro_torch.models.sharding import param_specs, placements
    cfg = get_config("zamba2-1.2b").reduced()
    mesh = make_host_mesh(device="cpu")
    try:
        pspecs = param_specs(cfg, S.params_shapes_for(cfg), mesh, "train")
        want = {k: placements(v, mesh) for k, v in flatten(pspecs).items()}
        assert T._table(mesh, pspecs) == want
        assert flatten(T._shard(mesh, pspecs)) == {
            f"{k}/{i}": pl for k, v in want.items() for i, pl in enumerate(v)}
        x = torch.arange(12.0).reshape(3, 4)
        d = T._place(x, mesh, (Shard(0), Shard(1)))
        for y in (d.to_local(), T._full(d),
                  T._local(d, mesh, (Replicate(), Replicate()))):
            assert y.data_ptr() == x.data_ptr() and torch.equal(y, x)
    finally:
        dist.destroy_process_group()


def test_placer_keeps_its_spec():
    """A leaf's ``_Placer`` keeps ``from_local``'s spec while the tensors
    it wraps keep their shape, stride and dtype, and makes a new one when
    they change; either way the ``DTensor`` is the one ``from_local``
    gives."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_host_mesh(device="cpu")
    try:
        want = (Shard(0), Replicate())
        placer = T._Placer(mesh, want)
        for shape in ((3, 4), (3, 4), (5, 2), (5, 2)):
            x = torch.randn(shape)
            got = placer(x)
            ref = DTensor.from_local(x, mesh, want, run_check=False)
            assert got.placements == ref.placements == want
            assert got._spec == ref._spec and got.shape == x.shape
            assert got.to_local().data_ptr() == x.data_ptr()
            assert torch.equal((got * 2).full_tensor(), x * 2)
        assert placer.meta == ((5, 2), (2, 1), torch.float32)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# against the reference, on a (1, 1) host mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.launch as launch
    import repro.launch.steps as steps
    import repro.models as models
    import repro.optim as optim
    from repro.checkpoint import ckpt
    from repro.models.config import InputShape as RefShape
    return dict(jax=jax, jnp=jnp, launch=launch, steps=steps, models=models,
                optim=optim, ckpt=ckpt, InputShape=RefShape)


def test_sharded_train_step_matches_the_reference(ref):
    """Two sharded AdamW steps from the reference's weights: each step's
    loss and metrics within ``LOSS_TOL``, the first step's moments (the
    clipped grads, scaled) leaf by leaf within ``GRAD_TOL`` of the
    leaf's largest magnitude, the params after two steps within
    ``GRAD_TOL`` relative L2."""
    from test_torch_train import GRAD_TOL, LOSS_TOL, stacked_flat

    from repro_torch.checkpoint import params_from_reference
    jax, jnp = ref["jax"], ref["jnp"]
    cfg = get_config("starcoder2-3b").reduced()
    b, s = 2, 16
    rp = ref["models"].init_params(cfg, jax.random.PRNGKey(3))
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, rp), cfg,
                               "cpu")
    batches = [train_batch(cfg, b, s, i) for i in range(2)]
    ropt = ref["optim"].get_optimizer("adamw", lr=LR)
    rmesh = ref["launch"].make_host_mesh()
    rfn, _ = ref["steps"].make_sharded_train_step(
        cfg, rmesh, ref["InputShape"]("t", s, b, "train"), ropt, remat=False)
    rs, want = ropt.init(rp), []
    with rmesh:
        for batch in batches:
            rp, rs, rm = rfn(rp, rs, {k: jnp.asarray(v.numpy())
                                      for k, v in batch.items()})
            want.append(({k: float(v) for k, v in rm.items()},
                         jax.tree_util.tree_map(np.asarray, rs)))
    mesh = make_host_mesh(device="cpu")
    try:
        topt = get_optimizer("adamw", lr=LR)
        fn, _ = T.make_sharded_train_step(
            cfg, mesh, InputShape("t", s, b, "train"), topt, remat=False)
        tstate, got = topt.init(tp), []
        for batch in batches:
            tp, tstate, tm = fn(tp, tstate, batch)
            got.append(({k: float(v) for k, v in tm.items()},
                        tree_map(T._full, tstate)))
        tp = tree_map(T._full, tp)
    finally:
        dist.destroy_process_group()
    for (gm, _), (wm, _) in zip(got, want):
        for k, v in wm.items():
            assert abs(gm[k] - v) <= LOSS_TOL * max(abs(v), 1e-6), (k, gm, wm)
    (_, g1), (_, w1) = got[0], want[0]
    for name in ("m", "v"):
        g = stacked_flat(getattr(g1, name))
        w = ref["ckpt"]._flatten(getattr(w1, name))
        assert sorted(g) == sorted(w)
        for k, x in w.items():
            scale = float(np.abs(x).max())
            assert float(np.abs(g[k] - x).max()) <= GRAD_TOL * scale, \
                f"{name}/{k}"
    gp = stacked_flat(tp)
    wp = ref["ckpt"]._flatten(jax.tree_util.tree_map(np.asarray, rp))
    assert rel_l2({k: torch.from_numpy(v) for k, v in gp.items()},
                  {k: torch.from_numpy(np.array(v))
                   for k, v in wp.items()}) <= GRAD_TOL


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

RECORD_KEYS = {"arch", "shape", "mesh", "chips", "notes", "n_layers",
               "params", "active_params", "optimized", "flops",
               "bytes_accessed", "collectives", "argument_size_in_bytes",
               "output_size_in_bytes", "trace_s", "totals_exact",
               "total_flops", "total_bytes_accessed",
               "total_collective_bytes"}
COLLECTIVE_KEYS = {"all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute", "total_bytes"}


def local_bytes(tree, specs, sizes: dict) -> int:
    """Bytes of rank 0's local shards of ``tree`` under ``specs``, from
    the specs and the mesh's axis sizes alone: each dim over the product
    of the sizes of the axes that split it."""
    total = 0
    flat = flatten(specs)
    for key, leaf in flatten(tree).items():
        shape = list(leaf.shape)
        for d, entry in enumerate(flat[key]):
            axes = () if entry is None else \
                ((entry,) if isinstance(entry, str) else entry)
            for a in axes:
                assert shape[d] % sizes[a] == 0
                shape[d] //= sizes[a]
        total += int(np.prod(shape)) * leaf.element_size()
    return total


def test_dryrun_record_on_the_multi_pod_mesh():
    """``run_one`` on 2 x 16 x 16 under its own fake group: the record's
    keys; collectives counted (the params gathered over "model"); the
    argument bytes equal to the local shards worked out from the specs;
    no group left; a group of another size refuses the run."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.models.sharding import (batch_specs, cache_specs,
                                             param_specs)
    from test_torch_sharding import MESHES as SPEC_MESHES
    assert not dist.is_initialized()
    rec = D.run_one("starcoder2-3b", "decode_32k", True)
    assert not dist.is_initialized()
    assert RECORD_KEYS <= set(rec) and not {
        "temp_size_in_bytes", "generated_code_size_in_bytes"} & set(rec)
    assert (rec["mesh"], rec["chips"], rec["totals_exact"]) == \
        ("2x16x16", 512, True)
    coll = rec["collectives"]
    assert set(coll) == COLLECTIVE_KEYS
    assert coll["all-gather"]["count"] > 0 and coll["total_bytes"] > 0
    assert coll["total_bytes"] == rec["total_collective_bytes"]
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0

    cfg = get_config("starcoder2-3b")
    shape = INPUT_SHAPES["decode_32k"]
    stand_in = SPEC_MESHES["2x16x16"]
    p, b, c = (S.params_shapes_for(cfg), S.batch_specs_for(cfg, shape),
               S.cache_specs_for(cfg, shape))
    want = (local_bytes(p, param_specs(cfg, p, stand_in, "serve"),
                        stand_in.shape)
            + local_bytes(b, batch_specs(cfg, b, stand_in), stand_in.shape)
            + local_bytes(c, cache_specs(cfg, c, stand_in), stand_in.shape))
    assert rec["argument_size_in_bytes"] == want

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="512 ranks"):
            D.run_one("starcoder2-3b", "decode_32k", True)
    finally:
        dist.destroy_process_group()


def test_collective_stats_on_a_hand_made_record():
    from repro_torch.launch.dryrun import collective_stats
    ops = [("_c10d_functional.all_gather_into_tensor.default", 64),
           ("_c10d_functional.all_gather_into_tensor.default", 36),
           ("c10d.allreduce_.default", 8),
           ("_c10d_functional.reduce_scatter_tensor.default", 16),
           ("_c10d_functional.all_to_all_single.default", 4),
           ("_c10d_functional.wait_tensor.default", 1000),
           ("c10d.broadcast_.default", 1000)]
    got = collective_stats(ops)
    assert got == {"all-gather": {"count": 2, "bytes": 100},
                   "all-reduce": {"count": 1, "bytes": 8},
                   "reduce-scatter": {"count": 1, "bytes": 16},
                   "all-to-all": {"count": 1, "bytes": 4},
                   "collective-permute": {"count": 0, "bytes": 0},
                   "total_bytes": 128}
    assert collective_stats([])["total_bytes"] == 0


def test_dryrun_command_runs_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape
    decode_32k`` with ``jax`` unimportable: exit 0, one record with the
    reference's keys written to ``--out``, and no ``jax`` or ``repro``
    module loaded."""
    out = tmp_path / "dryrun.json"
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None          # any import of jax now fails
        sys.argv = ["dryrun", "--arch", "starcoder2-3b", "--shape",
                    "decode_32k", "--out", {str(out)!r}]
        try:
            runpy.run_module("repro_torch.launch.dryrun",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = sorted(m for m, v in sys.modules.items() if v is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout + res.stderr
    assert "[ok] starcoder2-3b x decode_32k x 16x16" in res.stdout
    (rec,) = json.loads(out.read_text())
    assert RECORD_KEYS <= set(rec) and rec["chips"] == 256
    assert rec["collectives"]["total_bytes"] > 0


def test_run_wants_the_card_and_sets_up_no_group():
    """Without ``device``, ``launch.train.run`` wants the card: without
    one it raises before it sets up a process group."""
    from repro_torch.launch import train as T_train
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T_train.run(get_config("zamba2-1.2b").reduced(), steps=1,
                    global_batch=2, seq_len=8)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_sharded_steps_on_the_card():
    """On the card's ``nccl`` (1, 1) host mesh, reduced zamba2 (B3 and B4
    inside their Functions): the sharded train step bitwise the raw
    step, and the sharded prefill and decode bitwise the raw ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    cfg, b, s, _ = family_configs()["hybrid"]
    dev = torch.device("cuda")
    mesh = make_host_mesh()
    try:
        opt = get_optimizer("adamw", lr=LR)
        params = init_params(cfg, 0, dev)
        state = opt.init(params)
        batch = {k: v.to(dev) for k, v in train_batch(cfg, b, s, 0).items()}
        want = T.train_step(cfg, opt, params, state, batch)
        fn, _ = T.make_sharded_train_step(
            cfg, mesh, InputShape("t", s, b, "train"), opt)
        got = fn(params, state, batch)
        for g, w in zip(got, want):
            fg, fw = flatten(tree_map(T._full, g)), flatten(w)
            assert fg.keys() == fw.keys()
            assert all(torch.equal(fg[k], fw[k]) for k in fw)
        n = cache_len(s)
        first, *rest = [{k: v.to(dev) for k, v in x.items()}
                        for x in serve_batches(cfg, b, s)]
        pre, _ = T.make_sharded_prefill(cfg, mesh,
                                        InputShape("p", n, b, "prefill"))
        dec, _ = T.make_sharded_decode(cfg, mesh,
                                       InputShape("d", n, b, "decode"))
        logits, caches = pre(params, first)
        w_logits, w_caches = T.prefill_step(cfg, params, first, cache_len=n,
                                            window=None)
        for batch in rest:
            logits, caches = dec(params, batch, caches)
            w_logits, w_caches = T.decode_step(cfg, params, batch, w_caches,
                                               window=None)
        assert torch.equal(T._full(logits), w_logits)
        fg, fw = flatten(tree_map(T._full, caches)), flatten(w_caches)
        assert all(torch.equal(fg[k], fw[k]) for k in fw)
    finally:
        dist.destroy_process_group()
