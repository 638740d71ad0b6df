"""Vertical scaling's parts in the PyTorch port against the reference,
bitwise, and on the card.

On the CPU: ``observed_usage`` over func ids whose hash wraps uint32,
``shrink_amounts`` on the ``[S]`` and ``[P, S]`` layouts, the pool step
with resize on (``"lax"`` and the fused kernel's plain version, every
replacement policy) and ``pool_resize`` against the reference's,
``WarmPool`` with resize against the reference's, the block runner's
resize flavour eagerly at K = 4 with telemetry and chains, a resize
policy registered here (its own runner entry), the conservation,
slot-bound and outcome-count invariants on the port's own step, and the
JAX side of ``chip_smoke.GOLDEN_RZ``.  On the card (``cuda``): graph
replay == the CPU run.  ``simulate``'s matrix is in
``tests/test_torch_vertical.py``; the reference is reached through
fixtures, so the file also collects where JAX is absent (the GPU host).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.sim as T
from repro_torch.cluster import engine, graphs
from repro_torch.core import pool as P
from repro_torch.core import registry as TR
from repro_torch.core import xp
from repro_torch.core.pool_ref import WarmPool
from repro_torch.core.types import ClassMetrics, PoolConfig
from repro_torch.core.types import Trace as PortTrace
from repro_torch.kernels.pool_step import evict_place_cuda
from test_torch_vertical import (MODES, N_EVENTS, RESIZES, RZ_IDS,
                                 assert_bitwise, scenario, to_ref)

K = 4


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def qtrace():
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(3), N_EVENTS)


@pytest.fixture(scope="module")
def chained():
    from repro_torch.workloads import ChainConfig, chained_trace
    return chained_trace(ChainConfig(duration_s=90.0, seed=2)).head(160)


# ---------------------------------------------------------------------------
# the registry: observed usage and the shrink amounts
# ---------------------------------------------------------------------------

def test_observed_usage_matches_reference_across_uint32_wrap():
    """The Knuth hash ``func_id * 2654435761`` overflows uint32 from
    ids >= 2: the port's copy (numpy, as both reference call sites run
    it) wraps exactly as the reference's, over ids past 2^12 and up to
    int32's top."""
    from repro.core import registry as R
    rng = np.random.default_rng(0)
    fid = np.concatenate([np.arange(0, 5000), rng.integers(
        4096, 2 ** 31 - 1, 5000), [2 ** 31 - 1]]).astype(np.int32)
    size = rng.integers(1, 4000, fid.shape[0]).astype(np.float32)
    size[:7] = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 255.0)
    want = R.observed_usage(np, fid, size)
    got = TR.observed_usage(np, fid, size)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert (got <= np.maximum(size, 1.0)).all()
    assert (got >= np.minimum(size, 1.0)).all()


def shrink_case(rng, shape):
    """Whole-MB slot state: ``used <= alloc <= size``, some slots busy or
    empty."""
    size = rng.integers(30, 400, shape).astype(np.float32)
    alloc = np.floor(size * rng.uniform(0.4, 1.0, shape)).astype(np.float32)
    used = np.floor(alloc * rng.uniform(0.3, 1.0, shape)).astype(np.float32)
    valid = rng.random(shape) < 0.85
    idle = valid & (rng.random(shape) < 0.7)
    return used, alloc, size, idle, valid


@pytest.mark.parametrize("layout", ["S", "PS"])
@pytest.mark.parametrize("policy,min_mb", [("static", 0.0),
                                           ("fair_share", 0.0),
                                           ("fair_share", 48.0)])
def test_shrink_amounts_match_reference(policy, min_mb, layout):
    """``shrink_amounts`` over torch equals the reference's over
    ``jax.numpy`` and numpy, on one pool (``[S]``, 0-d scalars) and on
    stacked pools (``[P, S]``, ``[P, 1]`` columns), deficits from none
    to more than all the headroom."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import registry as R
    rng = np.random.default_rng(5)
    p = 1 if layout == "S" else 6
    used, alloc, size, idle, valid = shrink_case(rng, (p, 64))
    deficit = rng.integers(1, 3000, (p, 1)).astype(np.float32)
    deficit[1:2] = 0.0                  # a pool with nothing to reclaim
    free = rng.integers(0, 100, (p, 1)).astype(np.float32)
    cap = np.full((p, 1), 4096.0, np.float32)
    code = np.full((p, 1), R.RESIZE.resolve(policy), np.int32)
    mn = np.full((p, 1), min_mb, np.float32)
    cols = (mn, deficit, free, cap, code)
    if layout == "S":
        used, alloc, size, idle, valid = (a[0] for a in (used, alloc, size,
                                                         idle, valid))
        cols = tuple(a.reshape(()) for a in cols)
    mn, deficit, free, cap, code = cols
    arrays = (used, alloc, size, idle, valid, mn, deficit, free, cap)
    want_j = np.asarray(R.shrink_amounts(jnp, jnp.asarray(code), R.ResizeCtx(
        *(jnp.asarray(a) for a in arrays))))
    want_n = R.shrink_amounts(np, code, R.ResizeCtx(*arrays))
    got = TR.shrink_amounts(xp, torch.tensor(code), TR.ResizeCtx(
        *(torch.tensor(a) for a in arrays)))
    assert got.dtype == torch.float32 and got.shape == want_j.shape
    assert got.numpy().tobytes() == want_j.tobytes() == \
        np.asarray(want_n, np.float32).tobytes()
    if policy == "fair_share":
        assert got.sum() > 0
    else:
        assert got.sum() == 0


# ---------------------------------------------------------------------------
# the pool step and pool_resize with resize on
# ---------------------------------------------------------------------------

def ref_pools(J, JPoolConfig, rz_code, min_mb, cap=900.0, slots=12):
    """Three stacked reference pools, one per replacement policy, with
    resize on."""
    import jax
    import jax.numpy as jnp
    pools = [J.init_pool(JPoolConfig(cap, pol, slots, resize_policy=rz_code,
                                     resize_min_mb=min_mb))
             for pol in range(3)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pools)


def to_port(state) -> P.PoolState:
    return P.pool_state_from_numpy(
        {k: np.asarray(v) for k, v in state._asdict().items()}, "cpu")


def assert_state_equal(ref_state, got, what=""):
    for name, dt in {**P.STATE_DTYPES, **P.RESIZE_DTYPES}.items():
        r, g = np.asarray(getattr(ref_state, name)), getattr(got, name)
        assert g.dtype == dt, (what, name, g.dtype)
        assert r.tobytes() == g.numpy().tobytes(), (what, name)


def step_events(rng, n, n_funcs=14):
    """Quantized events (1/4 s apart, whole-MB sizes) with their observed
    usage, as the engines compute it."""
    fid = rng.integers(0, n_funcs, n).astype(np.int32)
    size = (40 + (fid * 37) % 200).astype(np.float32)
    warm = rng.integers(1, 64, n).astype(np.float32) / 64
    cold = warm + rng.integers(64, 960, n).astype(np.float32) / 64
    used = TR.observed_usage(np, fid, size)
    t = (np.arange(n) * 0.25).astype(np.float32)
    return [tuple(a[i] for a in (t, fid, size, warm, cold, used))
            for i in range(n)]


@pytest.mark.parametrize("backend", ["lax", "fused"])
@pytest.mark.parametrize("policy,min_mb", [("static", 0.0),
                                           ("fair_share", 0.0),
                                           ("fair_share", 48.0)])
def test_pool_step_batch_with_resize_matches_reference(policy, min_mb,
                                                       backend):
    """Three stacked pools (LRU, GreedyDual, FREQ) step the same events:
    every field, the seven resize fields among them, equals the
    reference's ``pool_step_batch`` after every event, for the sort
    composite and the fused kernel's plain version (the byte column they
    sum is the post-shrink ``alloc``)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import pool_jax as J
    from repro.core.types import PoolConfig as JPoolConfig
    code = TR.RESIZE.resolve(policy)
    jp = ref_pools(J, JPoolConfig, code, min_mb)
    tp = to_port(jp)
    jstep = jax.jit(lambda p, ev: J.pool_step_batch(
        p, ev, J.get_step_backend("lax")))
    tback = P.get_step_backend(backend)
    shrunk = 0
    for i, (t, f, s, w, c, u) in enumerate(step_events(
            np.random.default_rng(11), 160)):
        jp, jo = jstep(jp, J.Event(jnp.float32(t), jnp.int32(f),
                                   jnp.float32(s), jnp.int32(0),
                                   jnp.float32(w), jnp.float32(c),
                                   jnp.float32(u)))
        f32 = torch.float32
        tp, to = P.pool_step_batch(tp, P.Event(
            torch.tensor(t, dtype=f32), torch.tensor(f, dtype=torch.int32),
            torch.tensor(s, dtype=f32), torch.tensor(0, dtype=torch.int32),
            torch.tensor(w, dtype=f32), torch.tensor(c, dtype=f32),
            torch.tensor(u, dtype=f32)), tback)
        np.testing.assert_array_equal(np.asarray(jo), to.numpy(), str(i))
        assert_state_equal(jp, tp, i)
        shrunk += int((tp.valid & (tp.alloc < tp.size)).sum())
    assert (shrunk > 0) == (policy == "fair_share")
    assert int(tp.acc_alloc.sum()) > 0


def test_pool_resize_with_resize_matches_reference():
    """``pool_resize`` on resize-enabled pools frees each evicted
    resident's ``alloc`` and zeroes its ``alloc``/``used``, as the
    reference's (vmapped) does, from a mid-run state with shrunken
    limits."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import pool_jax as J
    from repro.core.types import PoolConfig as JPoolConfig
    jp = ref_pools(J, JPoolConfig, TR.RESIZE.resolve("fair_share"), 16.0)
    step = jax.jit(lambda p, ev: J.pool_step_batch(
        p, ev, J.get_step_backend("lax")))
    for t, f, s, w, c, u in step_events(np.random.default_rng(2), 200):
        jp, _ = step(jp, J.Event(*(jnp.asarray(v) for v in (
            np.float32(t), np.int32(f), np.float32(s), np.int32(0),
            np.float32(w), np.float32(c), np.float32(u)))))
        if bool(jnp.any(jp.valid & (jp.alloc < jp.size))):
            break                           # shrunken residents to evict
    assert bool(jnp.any(jp.valid & (jp.alloc < jp.size)))
    now = np.float32(22.5)
    caps = np.array([300.0, 520.0, 0.0], np.float32)
    want = jax.vmap(J.pool_resize, in_axes=(0, None, 0))(
        jp, jnp.float32(now), jnp.asarray(caps))
    got = P.pool_resize(to_port(jp), torch.tensor(now, dtype=torch.float32),
                       torch.tensor(caps))
    assert_state_equal(want, got)
    assert int(got.valid.sum()) < int(np.asarray(jp.valid).sum())


def test_pool_state_from_numpy_takes_all_resize_fields_or_none():
    from repro_torch.core.types import Policy
    static = P.init_pool(PoolConfig(64.0, Policy.LRU, 4), "cpu")
    rz = P.init_pool(PoolConfig(64.0, Policy.LRU, 4, resize_policy="static",
                                resize_min_mb=8.0), "cpu")
    assert static.alloc is None and rz.rz_policy.dtype == torch.int32
    fields = {k: v.numpy() for k, v in rz._asdict().items()}
    back = P.pool_state_from_numpy(fields, "cpu")
    for name, dt in {**P.STATE_DTYPES, **P.RESIZE_DTYPES}.items():
        assert getattr(back, name).dtype == dt
        assert torch.equal(getattr(back, name), getattr(rz, name))
    del fields["bneck"]
    with pytest.raises(ValueError, match="bneck"):
        P.pool_state_from_numpy(fields, "cpu")


# ---------------------------------------------------------------------------
# the sequential pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,min_mb", [("static", 0.0),
                                           ("fair_share", 0.0),
                                           ("fair_share", 48.0)])
@pytest.mark.parametrize("replacement", ["lru", "greedy_dual", "freq"])
def test_warm_pool_with_resize_matches_reference(replacement, policy,
                                                 min_mb, ref):
    """``WarmPool`` with a resize policy: every outcome, victim, limit,
    usage, free MB and run total equals the reference's, through a
    capacity shrink mid-run and an invalidation."""
    from conftest import quantized_trace
    from repro.core.pool_ref import WarmPool as RefPool
    from repro.core.types import ClassMetrics as RefMetrics
    from repro.core.types import PoolConfig as RefConfig
    code = TR.REPLACEMENT.resolve(replacement)
    tp = WarmPool(PoolConfig(512.0, code, 24, resize_policy=policy,
                             resize_min_mb=min_mb))
    rp = RefPool(RefConfig(512.0, code, 24, resize_policy=policy,
                           resize_min_mb=min_mb))
    tm, rm = ClassMetrics(), RefMetrics()
    tr = quantized_trace(np.random.default_rng(0), 500)
    for i in range(len(tr)):
        t = float(tr.t[i])
        if i == 200:
            assert [c.func_id for c in tp.resize(t, 384.0)] == \
                [c.func_id for c in rp.resize(t, 384.0)]
        if i == 350:
            assert tp.invalidate() == rp.invalidate()
        args = (t, int(tr.func_id[i]), float(tr.size_mb[i]),
                float(tr.warm_dur[i]), float(tr.cold_dur[i]))
        assert tp.access(*args, tm) == rp.access(*args, rm), i
        assert [c.func_id for c in tp.last_victims] == \
            [c.func_id for c in rp.last_victims], i
        assert [(c.alloc_mb, c.used_mb) for c in tp.containers] == \
            [(c.alloc_mb, c.used_mb) for c in rp.containers], i
        assert (tp.free_mb, tp.acc_used, tp.acc_alloc, tp.bneck) == \
            (rp.free_mb, rp.acc_used, rp.acc_alloc, rp.bneck), i
        assert tp.occupancy_ok() == rp.occupancy_ok(), i
    assert (tm.hits, tm.misses, tm.drops, tm.exec_time) == \
        (rm.hits, rm.misses, rm.drops, rm.exec_time)
    assert (tp.bneck > 0) == (policy == "fair_share")


# ---------------------------------------------------------------------------
# the block runner's resize flavour (eager on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("failing", [False, True], ids=["static", "failures"])
@pytest.mark.parametrize("mode", MODES)
def test_block_runner_matches_host_loop(chained, mode, failing):
    """The runner at K = 4 with resize, telemetry (windows of 3) and
    chains on: every length (part of a block, a block, blocks and a
    remainder) gives the host loop's outputs, vertical totals included,
    and counts its blocks and eager events."""
    tr = chained.head(3 * K + 5)
    t = tr.t
    scn = T.Scenario.cluster(
        (160.0, 200.0), max_slots=6, routing="slack_aware", telemetry=3,
        chains=T.Chains(slack=1.5), resize=T.Resize("fair_share", 4.0),
        failures=(((float(t[2]), float(t[9]) + 0.5, 0),) if failing
                  else None))
    cfg = scn.to_cluster_config()
    for length in (1, K - 1, K, K + 1, 3 * K + 5):
        head = tr.head(length)
        plan = scn.chains.compile(head)
        want = engine._simulate_cluster(cfg, head, "cpu", 0, mode, None,
                                        scn.failures, telemetry=3,
                                        chains=plan)
        before = dict(graphs.STATS)
        got = engine._simulate_cluster(cfg, head, "cpu", 0, mode, 1000,
                                       scn.failures, K, telemetry=3,
                                       chains=plan)
        np.testing.assert_array_equal(want[0].node, got[0].node)
        np.testing.assert_array_equal(want[0].outcome, got[0].outcome)
        assert_extras_equal(want[1], got[1], (mode, failing, length))
        assert (graphs.STATS["blocks"] - before["blocks"],
                graphs.STATS["eager_events"] - before["eager_events"]) \
            == (length // K, length % K)


def assert_extras_equal(a, b, what=""):
    assert set(a) == set(b), what
    for key in a:
        if isinstance(a[key], dict):
            assert_extras_equal(a[key], b[key], f"{what} {key}")
        elif a[key] is None:
            assert b[key] is None, (what, key)
        else:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                (what, key)


@pytest.mark.parametrize("mode", MODES)
def test_autoscaled_block_runner_matches_host_loop(qtrace, mode):
    """Autoscaled with resize, node scaling and an outage at K = 4: the
    re-split's ``commit`` writes the resized limits into the runner's
    carry; epochs shorter than and longer than the block."""
    tr = PortTrace(*qtrace).head(120)
    for epoch in (3, 17):
        scn = T.Scenario.cluster(
            (200.0, 400.0, 600.0), small_frac=(0.8, 0.5, 0.6),
            unified=(False, True, False), routing="least_loaded",
            max_slots=8, resize=T.Resize("fair_share", 16.0),
            failures=((float(tr.t[10]), float(tr.t[50]), 0),),
            autoscale=T.Autoscale(epoch_events=epoch, min_frac=0.3,
                                  max_frac=0.9, gain=0.3,
                                  spawn_drop_frac=0.2,
                                  retire_drop_frac=0.05, init_active=2))
        args = (scn.to_cluster_config(), scn.autoscale, tr, "cpu", 0, mode,
                scn.failures)
        want = engine._simulate_cluster_autoscale(*args)
        got = engine._simulate_cluster_autoscale(*args, K)
        for x, y in zip((want[0].node, want[0].outcome, want[1]),
                        (got[0].node, got[0].outcome, got[1])):
            np.testing.assert_array_equal(x, y, err_msg=f"{epoch}")
        assert_extras_equal(want[2], got[2], (mode, epoch))
        assert want[2]["vertical"]["bottlenecks"].sum() > 0


def test_runner_cache_key_holds_resize():
    """Resize on is its own entry, with the resize fields and the ``used``
    buffer; the policy code and floor are data loaded into the carry."""
    a = graphs.block_runner("cpu", 2, 8, "gather", False, K)
    b = graphs.block_runner("cpu", 2, 8, "gather", False, K, resize=True)
    assert a is not b and a.pools.alloc is None and a.events.used is None
    assert b.pools.alloc is not None
    assert b.events.used.shape == (K,)
    assert graphs.block_runner("cpu", 2, 8, "gather", False, K,
                               resize=True) is b
    cfg = T.Scenario.cluster((256.0, 512.0), max_slots=8, resize=T.Resize(
        "fair_share", 12.0)).to_cluster_config()
    b.load(*engine._run_inputs(cfg, "cpu"))
    assert (b.pools.rz_policy == TR.RESIZE.resolve("fair_share")).all()
    assert (b.pools.rz_min == 12.0).all()


@pytest.fixture
def port_resize_registry():
    """Roll back any resize policy a test registers in the port (the
    conftest fixture does it for the reference)."""
    specs, by_name = list(TR.RESIZE._specs), dict(TR.RESIZE._by_name)
    yield
    TR.RESIZE._specs[:] = specs
    TR.RESIZE._by_name.clear()
    TR.RESIZE._by_name.update(by_name)


def test_registered_resize_policy_matches_reference_and_gets_own_runner(
        ref, qtrace, port_resize_registry):
    """A third-party policy (shrink every idle resident to its floor),
    registered in both packages with one body: the chunked run equals the
    reference's, and the block runner takes a new entry, since its step
    where-chains every registered resize body."""
    def to_floor(xp, ctx):
        return xp.maximum(ctx.min_mb, ctx.used)

    before = graphs.block_runner("cpu", 2, 32, "fused", False, resize=True)
    ref.register_resize_policy("to_floor")(to_floor)
    T.register_resize_policy("to_floor")(to_floor)
    assert T.resize_policies() == ref.resize_policies()
    after = graphs.block_runner("cpu", 2, 32, "fused", False, resize=True)
    assert after is not before
    scn = scenario(T, "static", T.Resize("to_floor", 40.0))
    want = ref.simulate(to_ref(ref, scn), qtrace)
    got = T.simulate(scn, PortTrace(*qtrace), mode="fused", chunk_events=150,
                     device="cpu")
    assert_bitwise(want, got)
    assert got.summary()["bottleneck_events"] > 0


def test_resize_registry_keeps_the_references_codes(ref):
    assert T.resize_policies() == ["static", "fair_share"]
    for name in T.resize_policies():
        assert T.RESIZE.resolve(name) == ref.RESIZE.resolve(name)


# ---------------------------------------------------------------------------
# invariants on the port's step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rz", range(len(RESIZES)), ids=RZ_IDS)
def test_conservation_slot_bounds_counts(rz, mode, qtrace):
    """``tests/test_invariants.py``'s invariants on the port's own step,
    over the first 250 events of its trace (the shrink runs from the
    first ~100): after every event each pool's free plus the bytes its
    residents hold
    (``alloc`` with resize, ``size`` without) equals its capacity,
    bitwise in f32; ``used <= alloc <= size`` on every resident and
    ``free >= 0``; one known outcome an event."""
    cfg = scenario(T, "static", RESIZES[rz]).to_cluster_config()
    tr = PortTrace(*qtrace).head(250)
    n = cfg.n_nodes
    pools, routing, unified, cloud = engine._run_inputs(cfg, "cpu")
    step = engine._make_step(routing, unified, cloud, n, mode)
    events = engine.cluster_events(tr, n, "cpu",
                                   resize=cfg.resize_policy is not None)
    cap = pools.capacity.clone()
    outcomes, shrunk = [], False
    for i in range(len(tr)):
        pools, _, outcome = step(pools, engine._each(events, lambda a: a[i]))
        held = pools.size if pools.alloc is None else pools.alloc
        total = pools.free + torch.where(pools.valid, held, 0.0).sum(-1)
        assert torch.equal(total, cap), i
        assert (pools.free >= 0).all(), i
        if pools.alloc is not None:
            v = pools.valid
            assert not (v & ((pools.used > pools.alloc)
                             | (pools.alloc > pools.size))).any(), i
            shrunk |= bool((v & (pools.alloc < pools.size)).any())
        outcomes.append(int(outcome))
    out = np.array(outcomes)
    assert np.isin(out, (0, 1, 2)).all() and len(out) == len(tr)
    assert shrunk == (rz >= 2)


# ---------------------------------------------------------------------------
# the goldens of chip_smoke.py's vertical phase
# ---------------------------------------------------------------------------

def test_vertical_goldens_are_the_references(ref):
    """``chip_smoke.py``'s vertical phase holds the card to ``GOLDEN_RZ``:
    the reference's own results (``gather``) for the same scenarios on the
    stored quickstart trace and on the stored replay trace, which is the
    one the reference draws for ``benchmarks/vertical.py``."""
    from repro.core.types import Trace as RefTrace
    from repro.workloads import (SchemaConfig, synthesize_azure_schema,
                                 trace_from_tables)
    from repro_torch.sim.telemetry import trace_fingerprint
    from repro_torch.workloads import (benchmark_replay_trace,
                                       quickstart_trace)
    from test_torch_sim import _chip_smoke
    smoke = _chip_smoke()
    replay = benchmark_replay_trace()
    assert trace_fingerprint(replay) == smoke.GOLDEN_REPLAY_TRACE
    assert len(replay) == 192_047
    drawn = trace_from_tables(synthesize_azure_schema(SchemaConfig(
        n_funcs=400, n_minutes=240, rpm_total=700.0, seed=0)))
    if np.__version__.startswith("2.0."):   # zipf's stream is numpy's own
        assert trace_fingerprint(drawn) == smoke.GOLDEN_REPLAY_TRACE
    scns = smoke.vertical_scenarios(quickstart_trace(), replay)
    assert set(scns) == set(smoke.GOLDEN_RZ)
    # each runs on the card: a simulate run, a lane of the vertical
    # phase's sweep, or a lane of the sweep phase's replay sweep
    assert ({name for name, _, _ in smoke.VERTICAL_RUNS}
            | set(smoke.VERTICAL_SWEEP)
            | set(smoke.REPLAY_LANES.values())) == set(scns)
    for name, (scn, tr) in scns.items():
        chunk = smoke.RZ_REPLAY_CHUNK if len(tr) > smoke.RZ_REPLAY_CHUNK \
            else None
        r = ref.simulate(to_ref(ref, scn), RefTrace(*tr), chunk_events=chunk)
        assert r.scenario.label == scn.label
        assert smoke.rz_digests(r) == smoke.GOLDEN_RZ[name], name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")


def _card_trace(n, seed=1):
    """A quantized trace (1/64 s times, whole-MB sizes) from a seed, with
    func ids past 2^12 (the usage hash wraps)."""
    rng = np.random.default_rng(seed)
    q = 64
    large = rng.random(n) < 0.3
    fid = np.where(large, 5000 + rng.integers(0, 8, n),
                   rng.integers(0, 40, n)).astype(np.int32)
    size = np.where(large, 300 + fid % 8 * 10, 30 + fid % 40)
    warm = rng.integers(1, 5 * q, n) / q
    return PortTrace(
        t=(np.sort(rng.integers(0, 600 * q, n)) / q).astype(np.float32),
        func_id=fid, size_mb=size.astype(np.float32),
        cls=large.astype(np.int32), warm_dur=warm.astype(np.float32),
        cold_dur=(warm + rng.integers(q // 2, 10 * q, n) / q
                  ).astype(np.float32))


def _card_scenario(tr, variant):
    t_end = float(tr.t[-1])
    kw = dict(routing="size_aware", replacement="greedy_dual", max_slots=32,
              telemetry=graphs.BLOCK_EVENTS + 5,
              resize=T.Resize("fair_share", 24.0))
    if variant != "static":
        kw["failures"] = ((0.2 * t_end, 0.5 * t_end, 0),
                          (0.4 * t_end, 0.8 * t_end, 2))
    if variant == "autoscaled":
        kw["autoscale"] = dict(epoch_events=2 * graphs.BLOCK_EVENTS + 3,
                               min_frac=0.3, max_frac=0.9, gain=0.3,
                               spawn_drop_frac=0.1, retire_drop_frac=0.02,
                               init_active=2)
    return T.Scenario.cluster((512.0, 768.0, 1024.0),
                              small_frac=(0.8, 0.5, 0.7),
                              unified=(False, True, False), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["static", "failures", "autoscaled"])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_vertical_replay_matches_cpu(mode, variant):
    """Graph replay with resize and telemetry on equals the CPU's host
    loop bitwise, monolithic and chunked, under
    ``set_sync_debug_mode("error")``; the runner's counts and B1's
    launches are as stated, and the shrink ran."""
    _card()
    k = graphs.BLOCK_EVENTS
    tr = _card_trace(3 * (2 * k + 3) + 20)
    scn = _card_scenario(tr, variant)
    cpu = T.simulate(scn, tr, mode=mode, device="cpu")
    assert cpu.bottleneck_events > 0
    chunks = (None,) if variant == "autoscaled" else (None, 2 * k + 3)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for chunk in chunks:
            before, b1 = dict(graphs.STATS), evict_place_cuda.launches
            got = T.simulate(scn, tr, mode=mode, chunk_events=chunk,
                             device="cuda")
            spans = ([len(tr)] if chunk is None and variant != "autoscaled"
                     else [2 * k + 3] * 3 + [20])
            assert (graphs.STATS["blocks"] - before["blocks"],
                    graphs.STATS["eager_events"] - before["eager_events"]) \
                == (sum(c // k for c in spans), sum(c % k for c in spans))
            assert evict_place_cuda.launches - b1 \
                == (len(tr) if mode == "fused" else 0)
            assert_bitwise(cpu, got, (mode, variant, chunk))
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_cuda_resize_code_and_floor_are_data():
    """Another resize policy code or floor on the same cluster replays the
    cached graph (no new capture) and still equals the CPU."""
    _card()
    tr = _card_trace(2 * graphs.BLOCK_EVENTS + 9, seed=3)
    first = _card_scenario(tr, "static")
    T.simulate(first, tr, mode="fused", device="cuda")
    captures = graphs.STATS["captures"]
    for rz in ("static", T.Resize("fair_share", 64.0)):
        scn = dataclasses.replace(first, resize=rz)
        got = T.simulate(scn, tr, mode="fused", device="cuda")
        assert graphs.STATS["captures"] == captures
        assert_bitwise(T.simulate(scn, tr, mode="fused", device="cpu"), got)
