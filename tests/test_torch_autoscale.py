"""Autoscaled scenarios in the PyTorch port against the reference
``repro.sim``, bitwise.

On the CPU: the routing x step-mode grid (node, outcome, ``fracs``,
``active``, ``epoch_t`` and every summary key), node scaling with and
without failures, spawn under pressure and retirement when it
collapses from an ``init_active`` prefix, trailing partial and exact
epochs, the unified node left unresized, a ``used_n`` tie,
``pool_resize`` alone against the reference's (vmapped), the block
runner against the host loop at epochs around its block, the runner's
in-place commit and cache key, validation, and the JAX side of
``chip_smoke.GOLDEN_ASC``.  On the card (``cuda``): graph replay == the
CPU run with the runner's counts, and a shrink between epochs seen by
the next replay.  The reference (and ``conftest``, which imports it) is
reached through fixtures, so the file also collects where JAX is absent
(the GPU host).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.sim as T
from repro_torch.cluster import engine, graphs
from repro_torch.core import pool as P
from repro_torch.core.types import Trace as PortTrace
from repro_torch.kernels.pool_step import evict_place_cuda

MODES = ("gather", "vmap", "fused")
ROUTINGS = ("sticky", "least_loaded", "size_aware", "power_of_two",
            "cost_model")
#: The reference's own autoscalers (``tests/test_autoscale.py``,
#: ``tests/test_failures.py``).
ASC = dict(epoch_events=100, min_frac=0.4, max_frac=0.9, gain=0.2)
NODE_ASC = dict(ASC, spawn_drop_frac=0.05, retire_drop_frac=0.01,
                init_active=2)
N_EVENTS = 350          # three full epochs of 100 and a partial one of 50


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def qtrace():
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(1), N_EVENTS)


def het4(mod, routing="sticky", asc=ASC, failures=None):
    """The reference's ``het4``: a unified node rides along unresized."""
    return mod.Scenario.cluster((1024.0, 1024.0, 2048.0, 4096.0),
                                small_frac=(0.8, 0.8, 0.8, 0.5),
                                unified=(False, True, False, False),
                                routing=routing, max_slots=64,
                                autoscale=mod.Autoscale(**asc),
                                failures=failures)


def mid_windows(tr, nodes=(0, 2)):
    """The reference's outage windows over the middle of the trace."""
    t0 = float(tr.t[int(len(tr) * 0.25)])
    t1 = float(tr.t[int(len(tr) * 0.6)])
    return tuple((t0 + 3 * i, t1 + 11 * i, n) for i, n in enumerate(nodes))


def assert_bitwise(r, p, what=""):
    """Every per-event, per-epoch and summary output, bitwise."""
    for f in ("node", "outcome", "per_node", "fracs", "active", "n_active",
              "epoch_t", "invalidated", "node_up"):
        x, y = getattr(r, f), getattr(p, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            x = np.asarray(x)
            assert x.dtype == y.dtype, (what, f, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
    assert r.summary() == p.summary(), what


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_grid(ref, qtrace):
    """The reference's ``gather`` run per routing (its modes are bitwise
    equal to one another, by its own tests); one compiled program."""
    cache = {}

    def run(routing):
        if routing not in cache:
            cache[routing] = ref.simulate(het4(ref, routing), qtrace)
        return cache[routing]
    return run


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("routing", ROUTINGS)
def test_autoscale_matches_reference(routing, mode, ref_grid, qtrace):
    r = ref_grid(routing)
    p = T.simulate(het4(T, routing), PortTrace(*qtrace), mode=mode,
                   device="cpu")
    assert_bitwise(r, p, (routing, mode))
    assert p.fracs.shape == (4, 4) and p.epoch_t.shape == (4,)
    assert (p.fracs[-1] == p.fracs[-2]).all()       # the partial epoch


@pytest.mark.parametrize("failing", [False, True],
                         ids=["nodes", "nodes+failures"])
@pytest.mark.parametrize("mode", MODES)
def test_node_scaling_matches_reference(ref, qtrace, mode, failing):
    """Node add/remove with the re-split, with a failure schedule
    (``tests/test_failures.py:82``) and without one (:114)."""
    fails = mid_windows(qtrace) if failing else None
    r = ref.simulate(het4(ref, "size_aware", NODE_ASC, fails), qtrace)
    p = T.simulate(het4(T, "size_aware", NODE_ASC, fails),
                   PortTrace(*qtrace), mode=mode, device="cpu")
    assert_bitwise(r, p, (mode, failing))
    assert p.active.dtype == bool and (p.node_up is None) == (not failing)
    assert p.n_invalidated > 0


def surge_then_calm():
    """150 events of many functions on 1/64 s steps (drops: spawn), then
    200 of one small function with short runs (hits: retire)."""
    rng = np.random.default_rng(5)
    q, n1, n2 = 64, 150, 200
    fid1 = rng.integers(0, 60, n1)
    t1 = np.arange(n1) / q
    t2 = t1[-1] + (1 + np.arange(n2)) * 2.0
    return PortTrace(
        t=np.concatenate([t1, t2]).astype(np.float32),
        func_id=np.concatenate([fid1, np.zeros(n2)]).astype(np.int32),
        size_mb=np.concatenate([40 + fid1 % 20, np.full(n2, 30)]
                               ).astype(np.float32),
        cls=np.zeros(n1 + n2, np.int32),
        warm_dur=np.full(n1 + n2, 0.5, np.float32),
        cold_dur=np.full(n1 + n2, 3.0, np.float32))


def test_spawn_under_pressure_then_retire(ref):
    """A cluster that starts with its first node only spawns the next
    inactive node each epoch of the surge and retires nodes once drops
    stop, never below one; retired residents count as invalidated."""
    tr = surge_then_calm()
    asc = dict(epoch_events=50, spawn_drop_frac=0.05,
               retire_drop_frac=0.01, init_active=1)
    scn = [mod.Scenario.cluster((512.0,) * 3, routing="least_loaded",
                                max_slots=16, autoscale=asc)
           for mod in (ref, T)]
    from repro.core.types import Trace as RefTrace
    r = ref.simulate(scn[0], RefTrace(*tr))
    p = T.simulate(scn[1], tr, device="cpu")
    assert_bitwise(r, p)
    n_act = p.n_active.tolist()
    assert (p.node[:50] == 0).all()                 # only node 0 is live
    assert max(n_act) == 3 and n_act[-1] == 1 and min(n_act) == 1
    peak = n_act.index(3)
    assert n_act[:peak + 1] == sorted(n_act[:peak + 1])
    assert n_act[peak:] == sorted(n_act[peak:], reverse=True)
    assert p.n_invalidated > 0


@pytest.mark.parametrize("n", [256, 4 * 64 + 1], ids=["exact", "partial"])
def test_partial_and_exact_epochs(ref, n):
    """A trace that ends on an epoch boundary and one that ends one event
    into a new epoch: the partial epoch gets no re-split, so its row
    repeats the previous one and it ends where the exact run ends."""
    from conftest import quantized_trace
    tr = quantized_trace(np.random.default_rng(2), n)
    scn = [mod.Scenario.kiss(1024.0, max_slots=96,
                             autoscale=mod.Autoscale(epoch_events=64))
           for mod in (ref, T)]
    p = T.simulate(scn[1], PortTrace(*tr), device="cpu")
    assert_bitwise(ref.simulate(scn[0], tr), p, n)
    assert p.fracs.shape == (-(-n // 64), 1)
    assert len(set(p.fracs[:, 0].tolist())) > 1          # the split moved
    if n % 64:
        assert (p.fracs[-1] == p.fracs[-2]).all()
        exact = T.simulate(scn[1], PortTrace(*tr).head(256), device="cpu")
        np.testing.assert_array_equal(exact.fracs, p.fracs[:-1])


# ---------------------------------------------------------------------------
# the epoch boundary alone
# ---------------------------------------------------------------------------

def busy_cluster(unified=(False, True, False), s=8):
    """A host carry over nodes of 1,000 MB whose pools hold whole-MB
    residents, some busy past t = 10."""
    n_nodes = len(unified)
    cfg = T.Scenario.cluster((1000.0,) * n_nodes, small_frac=0.8,
                             unified=unified, max_slots=s
                             ).to_cluster_config()
    pools, routing, unified, cloud = engine._run_inputs(cfg, "cpu")
    rng = np.random.default_rng(3)
    shape = pools.valid.shape
    size = torch.tensor(rng.integers(20, 120, shape), dtype=torch.float32)
    valid = torch.tensor(rng.random(shape) < 0.8)
    used = torch.where(valid, size, 0.0).sum(-1)
    pools = pools._replace(
        func_id=torch.where(valid, 7, -1).to(torch.int32), size=size,
        valid=valid, free=pools.capacity - used,
        seq=torch.tensor(rng.permutation(shape[0] * s).reshape(shape),
                         dtype=torch.float32),
        last_use=torch.tensor(rng.integers(0, 9, shape), dtype=torch.float32),
        busy_until=torch.tensor(rng.integers(0, 20, shape),
                                dtype=torch.float32))
    step = engine._make_step(routing, unified, cloud, n_nodes, "gather")
    carry = engine._HostCarry(step, pools,
                              torch.ones((1, n_nodes), dtype=bool))
    return cfg, carry, unified


def test_unified_node_is_never_resized():
    """All pressure on the small class: every KiSS node's split and pools
    move, the unified node's pools stay as they were."""
    cfg, carry, unified = busy_cluster()
    before = carry.pools
    carry.press[0, :, 0] = 40.0
    inputs = engine._autoscale_inputs(
        cfg, T.Autoscale(epoch_events=10, gain=0.5), "cpu")
    frac = engine._epoch_end(carry, inputs.frac0, inputs, unified,
                             torch.tensor(10.0), torch.tensor(10.0))
    assert frac[0].tolist() == pytest.approx([0.9, 0.8, 0.9])
    after = carry.pools
    for f in ("capacity", "free", "valid"):
        a, b = getattr(before, f), getattr(after, f)
        assert torch.equal(a[2:4], b[2:4]), f             # the unified node
        assert not torch.equal(a[0:2], b[0:2]), f
    assert (after.free[[1, 5]] < 0).any()          # busy residents stay


def test_used_n_tie_retires_the_first():
    """Two active nodes with equal MB in use: retirement takes the lower
    index (``argmin``'s first extreme, as ``jnp.argmin``), and counts its
    residents as invalidated.  All nodes unified (allowed with node
    scaling), so no resize moves the crafted balances."""
    cfg, carry, unified = busy_cluster(unified=(True, True, True))
    pools = carry.pools
    cap = torch.full_like(pools.capacity, 500.0)
    free = cap - torch.tensor([100.0, 60.0, 90.0, 60.0, 90.0, 60.0])
    carry.pools = pools._replace(capacity=cap, free=free)
    asc = T.Autoscale(epoch_events=10, gain=0.0, spawn_drop_frac=0.5,
                      retire_drop_frac=0.1)
    inputs = engine._autoscale_inputs(cfg, asc, "cpu")
    n_res = pools.valid.view(3, -1).sum(1)
    engine._epoch_end(carry, inputs.frac0, inputs, unified,
                      torch.tensor(-1.0), torch.tensor(10.0))
    assert carry.active[0].tolist() == [True, False, True]
    assert carry.inval[0].tolist() == [0, int(n_res[1]), 0]
    assert not carry.pools.valid[2:4].any()


def test_pool_resize_matches_reference():
    """``pool_resize`` on stacked pools of every replacement policy, with
    busy residents (so a shrink leaves ``free`` negative), against the
    reference's vmapped over the pool axis, bitwise on every field."""
    import jax
    import jax.numpy as jnp
    from repro.core import pool_jax as J
    rng = np.random.default_rng(11)
    p, s = 6, 24
    shape = (p, s)
    valid = rng.random(shape) < 0.7
    size = np.where(valid, rng.integers(10, 200, shape), 0.0)
    cap = np.float32(size.sum(1) + rng.integers(0, 50, p))
    fields = dict(
        func_id=np.where(valid, rng.integers(0, 30, shape), -1),
        size=size, last_use=rng.integers(0, 64, shape) / 4,
        freq=rng.integers(1, 5, shape), gd_pri=rng.integers(0, 99, shape) / 8,
        busy_until=rng.integers(0, 40, shape) / 2,
        seq=np.stack([rng.permutation(s) + 1 for _ in range(p)]),
        valid=valid, capacity=cap, free=cap - size.sum(1),
        clock=rng.integers(0, 9, p) / 4, next_seq=np.full(p, s + 1),
        policy=np.arange(p) % 3)
    dts = {k: np.dtype(str(v).split(".")[-1])
           for k, v in P.STATE_DTYPES.items()}
    fields = {k: np.asarray(v).astype(dts[k]) for k, v in fields.items()}
    new_cap = np.float32(cap * np.array([0.2, 0.5, 1.0, 1.3, 0.0, 0.7]))
    now = np.float32(10.0)
    want = jax.vmap(J.pool_resize, in_axes=(0, None, 0))(
        J.PoolState(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.float32(now), jnp.asarray(new_cap))
    got = P.pool_resize(P.pool_state_from_numpy(fields, "cpu"),
                        torch.tensor(now), torch.tensor(new_cap))
    for name in P.STATE_DTYPES:
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert g.dtype == P.STATE_DTYPES[name], name
        np.testing.assert_array_equal(w, g.numpy(), err_msg=name)
    assert (got.free < 0).any() and (~got.valid & torch.tensor(valid)).any()
    assert torch.equal(got.clock, torch.tensor(fields["clock"]))


# ---------------------------------------------------------------------------
# the block runner's autoscaled flavour (eager on the CPU)
# ---------------------------------------------------------------------------

K = 4


@pytest.fixture(scope="module")
def short_trace():
    from conftest import quantized_trace
    return PortTrace(*quantized_trace(np.random.default_rng(7), 40,
                                      n_small=8, n_large=3,
                                      horizon_s=60.0))


def short_scenario(tr, epoch, failing):
    t = tr.t
    fails = (((float(t[3]), float(t[20]) + 0.5, 0),) if failing else None)
    return T.Scenario.cluster(
        (300.0, 600.0, 900.0), small_frac=(0.8, 0.5, 0.6),
        unified=(False, True, False), routing="least_loaded", max_slots=8,
        autoscale=T.Autoscale(epoch_events=epoch, min_frac=0.3,
                              max_frac=0.9, gain=0.3, spawn_drop_frac=0.2,
                              retire_drop_frac=0.05, init_active=2),
        failures=fails)


def run_port(scn, tr, mode, block_events):
    return engine._simulate_cluster_autoscale(
        scn.to_cluster_config(), scn.autoscale, tr, "cpu", 0, mode,
        scn.failures, block_events)


def assert_runs_equal(a, b, what=""):
    for x, y in zip((a[0].node, a[0].outcome, a[1]),
                    (b[0].node, b[0].outcome, b[1])):
        np.testing.assert_array_equal(x, y, err_msg=what)
    for f in ("active", "invalidated", "node_up"):
        x, y = a[2][f], b[2][f]
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("epoch", [1, 3, K, 5, 17])
def test_block_runner_matches_host_loop(short_trace, epoch, mode):
    """Epochs shorter than, equal to and longer than the block (17: four
    blocks and an eager event, then a partial epoch of six), with node
    scaling and an outage: the runner equals the host loop and counts
    the blocks and eager events of every epoch."""
    tr = short_trace
    for failing in (False, True):
        scn = short_scenario(tr, epoch, failing)
        want = engine._simulate_cluster_autoscale_torch(
            scn.to_cluster_config(), scn.autoscale, tr, "cpu", mode=mode,
            failures=scn.failures)
        before = dict(graphs.STATS)
        got = run_port(scn, tr, mode, block_events=K)
        assert_runs_equal(want, got, (epoch, mode, failing))
        spans = [e - s for s, e in engine._epochs(len(tr), epoch)]
        assert graphs.STATS["blocks"] - before["blocks"] \
            == sum(c // K for c in spans)
        assert graphs.STATS["eager_events"] - before["eager_events"] \
            == sum(c % K for c in spans)
        assert graphs.STATS["captures"] == before["captures"]


def test_runner_commit_writes_in_place(short_trace):
    """A re-split's new pools, membership and invalidations land in the
    runner's own storage (the tensors a captured graph reads)."""
    scn = short_scenario(short_trace, 5, False)
    cfg = scn.to_cluster_config()
    runner = graphs.block_runner("cpu", 3, 8, "gather", False, K,
                                 autoscaled=True)
    pools, routing, unified, cloud = engine._run_inputs(cfg, "cpu")
    inputs = engine._autoscale_inputs(cfg, scn.autoscale, "cpu")
    runner.load(pools, routing, unified, cloud, inputs.active0)
    def storage():
        return [a.data_ptr() for a in runner.pools if a is not None] + [
            runner.active.data_ptr(), runner.inval.data_ptr()]
    ptrs = storage()
    ev = engine.cluster_events(short_trace.head(5), 3, "cpu")
    node = torch.empty((5, 1), dtype=torch.int32)
    runner.run_chunk(ev, None, None, node, torch.empty_like(node))
    runner.press.fill_(3.0)
    runner.dropw.fill_(0.0)                       # no drops: retire
    engine._epoch_end(runner, inputs.frac0, inputs, unified,
                      ev.t.amax(), torch.tensor(5.0))
    assert storage() == ptrs
    assert runner.active.sum() == 1 and not runner.active[0, 2]
    f32 = np.float32
    np.testing.assert_array_equal(            # an even split: frac stays
        runner.pools.capacity.numpy()[[0, 1]],
        [f32(300.0) * f32(0.8), f32(300.0) * (f32(1.0) - f32(0.8))])


def test_runner_cache_key_separates_the_autoscaled_flavour():
    a = graphs.block_runner("cpu", 2, 8, "gather", False, K)
    b = graphs.block_runner("cpu", 2, 8, "gather", False, K,
                            autoscaled=True)
    assert a is not b and not a.autoscaled and b.autoscaled
    assert graphs.block_runner("cpu", 2, 8, "gather", False, K,
                               autoscaled=True) is b
    assert graphs.block_runner("cpu", 2, 8, "gather", True, K,
                               autoscaled=True) is not b


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_validation_errors(qtrace):
    """The reference's checks, in the port's ``Scenario`` and
    ``Autoscale``; ``chunk_events`` with autoscale raises ``ValueError``
    as in the reference, and so does a ``resize`` that is not one."""
    sc = T.Scenario.kiss(1024.0, autoscale={"epoch_events": 64})
    assert sc.autoscale == T.Autoscale(epoch_events=64)
    assert sc.label == "kiss-1n-sticky-lru-autoscaled"
    with pytest.raises(ValueError, match="Autoscale"):
        T.Scenario.kiss(1024.0, autoscale=5)
    with pytest.raises(ValueError, match="KiSS node"):
        T.Scenario.baseline(1024.0, autoscale=T.Autoscale())
    T.Scenario.baseline(1024.0, autoscale=T.Autoscale(spawn_drop_frac=0.1))
    with pytest.raises(ValueError, match="init_active"):
        T.Scenario.cluster((1024.0,) * 2, autoscale=T.Autoscale(
            spawn_drop_frac=0.1, init_active=3))
    with pytest.raises(ValueError, match="inside"):
        T.Scenario.kiss(1024.0, small_frac=0.95, autoscale=T.Autoscale())
    for bad in (dict(epoch_events=0), dict(min_frac=0.9, max_frac=0.5),
                dict(gain=-1.0), dict(retire_drop_frac=0.1),
                dict(spawn_drop_frac=1.5),
                dict(spawn_drop_frac=0.1, retire_drop_frac=0.2),
                dict(spawn_drop_frac=0.1, init_active=0)):
        with pytest.raises(ValueError):
            T.Autoscale(**bad)
    with pytest.raises(ValueError, match="chunk_events"):
        T.simulate(het4(T), PortTrace(*qtrace), chunk_events=100,
                   device="cpu")
    # resize is ported (ROADMAP A11): a bad value raises as in the reference
    with pytest.raises(ValueError, match="resize"):
        T.Scenario.kiss(1024.0, resize=object())


def test_autoscale_goldens_are_the_references(ref):
    """``chip_smoke.py``'s autoscale phase holds the card to
    ``GOLDEN_ASC``: the reference's own results (``gather``) for the same
    scenarios (``chip_smoke.autoscale_scenarios``) on the stored
    quickstart trace."""
    from repro.core.types import Trace as RefTrace
    from repro_torch.workloads import quickstart_trace
    from test_torch_sim import _chip_smoke
    smoke = _chip_smoke()
    trace = quickstart_trace()
    scns = smoke.autoscale_scenarios(trace)
    assert set(scns) == set(smoke.GOLDEN_ASC)
    for name, scn in scns.items():
        kw = {f.name: getattr(scn, f.name) for f in dataclasses.fields(scn)}
        kw["autoscale"] = ref.Autoscale(**dataclasses.asdict(scn.autoscale))
        if scn.failures is not None:
            kw["failures"] = ref.Failures(scn.failures.windows)
        r = ref.simulate(ref.Scenario(**kw), RefTrace(*trace))
        assert r.scenario.label == scn.label
        assert smoke.autoscale_digests(r) == smoke.GOLDEN_ASC[name], name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")


def _card_trace(n, seed=1):
    """A quantized trace (1/64 s times, whole-MB sizes) from a seed."""
    rng = np.random.default_rng(seed)
    q = 64
    large = rng.random(n) < 0.3
    fid = np.where(large, 1000 + rng.integers(0, 8, n),
                   rng.integers(0, 40, n)).astype(np.int32)
    size = np.where(large, 300 + fid % 8 * 10, 30 + fid % 40)
    warm = rng.integers(1, 5 * q, n) / q
    return PortTrace(
        t=(np.sort(rng.integers(0, 600 * q, n)) / q).astype(np.float32),
        func_id=fid, size_mb=size.astype(np.float32),
        cls=large.astype(np.int32), warm_dur=warm.astype(np.float32),
        cold_dur=(warm + rng.integers(q // 2, 10 * q, n) / q
                  ).astype(np.float32))


def _card_scenario(tr, nodes, failing):
    t_end = float(tr.t[-1])
    asc = dict(epoch_events=2 * graphs.BLOCK_EVENTS + 3, min_frac=0.3,
               max_frac=0.9, gain=0.3)
    if nodes:
        asc.update(spawn_drop_frac=0.1, retire_drop_frac=0.02,
                   init_active=2)
    return T.Scenario.cluster(
        (512.0, 1024.0, 2048.0), small_frac=(0.8, 0.5, 0.7),
        unified=(False, True, False), routing="size_aware",
        replacement="greedy_dual", max_slots=64, autoscale=asc,
        failures=(((0.2 * t_end, 0.5 * t_end, 0),
                   (0.4 * t_end, 0.8 * t_end, 2)) if failing else None))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["split", "nodes", "nodes+failures"])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_autoscale_replay_matches_cpu(mode, variant):
    """An autoscaled run on the card (each epoch's blocks graph replays,
    its remainder eager, the re-split between epochs) equals the CPU's
    host loop bitwise under ``set_sync_debug_mode("error")``; the
    runner's counts and B1's launches are as stated."""
    _card()
    k = graphs.BLOCK_EVENTS
    tr = _card_trace(3 * (2 * k + 3) + 20)
    scn = _card_scenario(tr, variant != "split", variant.endswith("failures"))
    cpu = T.simulate(scn, tr, mode=mode, device="cpu")
    torch.cuda.set_sync_debug_mode("error")
    try:
        before, b1 = dict(graphs.STATS), evict_place_cuda.launches
        got = T.simulate(scn, tr, mode=mode, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    spans = [2 * k + 3] * 3 + [20]
    assert graphs.STATS["blocks"] - before["blocks"] \
        == sum(c // k for c in spans)
    assert graphs.STATS["eager_events"] - before["eager_events"] \
        == sum(c % k for c in spans)
    assert evict_place_cuda.launches - b1 \
        == (len(tr) if mode == "fused" else 0)
    assert_bitwise(cpu, got, (mode, variant))
    if variant != "split":
        assert len(set(got.n_active.tolist())) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_replay_sees_the_resize(mode):
    """A first epoch of small-class pressure moves every KiSS node's
    split to ``max_frac``, shrinking its large pool; the next epoch's
    replays must step the resized pools: the card equals the CPU, whose
    second epoch differs from the same run with ``gain = 0``."""
    _card()
    k = graphs.BLOCK_EVENTS
    tr = _card_trace(4 * k, seed=4)
    base = _card_scenario(tr, False, False)
    shrink = dataclasses.replace(base, autoscale=T.Autoscale(
        epoch_events=2 * k, min_frac=0.3, max_frac=0.9, gain=0.9))
    still = dataclasses.replace(base, autoscale=T.Autoscale(
        epoch_events=2 * k, min_frac=0.3, max_frac=0.9, gain=0.0))
    cpu = T.simulate(shrink, tr, mode=mode, device="cpu")
    assert (cpu.fracs[0, [0, 2]] == np.float32(0.9)).all()
    flat = T.simulate(still, tr, mode=mode, device="cpu").outcome
    np.testing.assert_array_equal(cpu.outcome[:2 * k], flat[:2 * k])
    assert not np.array_equal(cpu.outcome[2 * k:], flat[2 * k:])
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = T.simulate(shrink, tr, mode=mode, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert_bitwise(cpu, got, mode)
