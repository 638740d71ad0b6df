"""Telemetry in the PyTorch port against the reference ``repro.sim``,
bitwise.

On the CPU: every window array (``counts``, ``free_mb``, ``occupancy``,
``invalidated``, ``nodes_up``, ``nodes_active``, ``chain_miss`` and the
time axis) for every routing x step mode, with failures, autoscaled with
node scaling and outages (a retirement's invalidations in the window of
its epoch's last event), and chunked at sizes that divide the window and
that do not; the block runner run eagerly at K = 4 against the host
loop, static and autoscaled, with telemetry and chains on; window sums
against the summary totals; the knob, its sugar and its off switch; the
trace-event export and the manifest against the reference's; the
runner's cache key; and the JAX side of ``chip_smoke.GOLDEN_TEL``.  On
the card (``cuda``): graph replay == the CPU run in every mode with no
host sync, and a second trace of another length on the same cluster
replays the cached graph.  The reference (and ``conftest``, which
imports it) is reached through fixtures, so the file also collects
where JAX is absent (the GPU host).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro_torch.sim as T
from repro_torch.cluster import engine, graphs
from repro_torch.core.types import Trace as PortTrace
from repro_torch.kernels.pool_step import evict_place_cuda

MODES = ("gather", "vmap", "fused")
ROUTINGS = ("sticky", "least_loaded", "size_aware", "power_of_two",
            "cost_model", "slack_aware")
WINDOW = 32
TEL_FIELDS = ("counts", "free_mb", "occupancy", "invalidated", "nodes_up",
              "nodes_active", "chain_miss", "t_start", "t_end",
              "event_start")
#: The reference's node autoscaler (``tests/test_telemetry.py``).
NODE_ASC = dict(epoch_events=100, min_frac=0.4, max_frac=0.9, gain=0.2,
                spawn_drop_frac=0.05, retire_drop_frac=0.01, init_active=2)
K = 4


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


def qtrace(seed, n):
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(seed), n)


def het4(mod, routing="sticky", failures=None, autoscale=None,
         telemetry=WINDOW):
    """The reference's ``het4``, with 64 slots a pool."""
    return mod.Scenario.cluster((1024.0, 1024.0, 2048.0, 4096.0),
                                small_frac=(0.8, 0.8, 0.8, 0.5),
                                unified=(False, True, False, False),
                                routing=routing, max_slots=64,
                                failures=failures, autoscale=autoscale,
                                telemetry=telemetry)


def mid_windows(tr, nodes=(0, 2)):
    """The reference's outage windows over the middle of the trace."""
    t0 = float(tr.t[int(len(tr) * 0.25)])
    t1 = float(tr.t[int(len(tr) * 0.6)])
    return tuple((t0 + 3 * i, t1 + 11 * i, n) for i, n in enumerate(nodes))


def to_ref(ref, scn):
    """The reference's ``Scenario`` with every field of the port's."""
    kw = {f.name: getattr(scn, f.name) for f in dataclasses.fields(scn)}
    if scn.autoscale is not None:
        kw["autoscale"] = ref.Autoscale(**dataclasses.asdict(scn.autoscale))
    if scn.failures is not None:
        kw["failures"] = ref.Failures(scn.failures.windows)
    if scn.telemetry is not None:
        kw["telemetry"] = ref.Telemetry(scn.telemetry.window_events)
    if scn.chains is not None:
        kw["chains"] = ref.Chains(**dataclasses.asdict(scn.chains))
    return ref.Scenario(**kw)


def assert_tel_equal(a, b, what=""):
    for f in TEL_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (what, f, x.dtype, y.dtype)
        assert x.tobytes() == y.tobytes(), (what, f, x, y)
    assert a.window_events == b.window_events


def assert_bitwise(r, p, what=""):
    """Per-event outputs, every window array and every summary key."""
    for f in ("node", "outcome", "invalidated", "node_up", "fracs",
              "active"):
        x, y = getattr(r, f), getattr(p, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), y,
                                          err_msg=f"{what} {f}")
    assert (r.telemetry is None) == (p.telemetry is None), what
    if r.telemetry is not None:
        assert_tel_equal(r.timeline(), p.timeline(), what)
    assert r.summary() == p.summary(), what


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def static_trace():
    return qtrace(0, 200)


@pytest.fixture(scope="module")
def ref_static(ref, static_trace):
    """The reference's ``gather`` run per routing (its modes are bitwise
    equal to one another, by its own tests)."""
    cache = {}

    def run(routing):
        if routing not in cache:
            cache[routing] = ref.simulate(het4(ref, routing), static_trace)
        return cache[routing]
    return run


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("routing", ROUTINGS)
def test_static_windows_match_reference(routing, mode, ref_static,
                                        static_trace):
    p = T.simulate(het4(T, routing), PortTrace(*static_trace), mode=mode,
                   device="cpu")
    assert_bitwise(ref_static(routing), p, (routing, mode))
    assert len(p.timeline()) == 7 and (p.timeline().nodes_up == 4).all()


@pytest.fixture(scope="module")
def dyn_trace():
    return qtrace(1, 450)


@pytest.fixture(scope="module")
def ref_dynamic(ref, dyn_trace):
    cache = {}

    def run(variant):
        if variant not in cache:
            cache[variant] = ref.simulate(
                dynamic(ref, variant, dyn_trace), dyn_trace)
        return cache[variant]
    return run


def dynamic(mod, variant, tr):
    fails = mid_windows(tr) if variant in ("failures", "both") else None
    asc = (mod.Autoscale(**NODE_ASC) if variant in ("autoscale", "both")
           else None)
    return het4(mod, "size_aware", failures=fails, autoscale=asc,
                telemetry=64)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", ["failures", "autoscale", "both"])
def test_dynamic_windows_match_reference(variant, mode, ref_dynamic,
                                         dyn_trace):
    """Failure recovery and node retirement both invalidate residents:
    the invalidation series and the up/active counts, bitwise.  The
    autoscaler retires a node at its first epoch's end (event 99), whose
    residents land in window 1."""
    p = T.simulate(dynamic(T, variant, dyn_trace), PortTrace(*dyn_trace),
                   mode=mode, device="cpu")
    assert_bitwise(ref_dynamic(variant), p, (variant, mode))
    tel = p.timeline()
    assert tel.invalidated.sum() == p.n_invalidated > 0
    if variant != "failures":
        assert tel.invalidated[1] > 0 and tel.nodes_active[0] == 2
        assert (tel.nodes_active[1:] == 1).all()
    if variant != "autoscale":
        assert tel.nodes_up.min() < 4


@pytest.fixture(scope="module")
def chunk_trace():
    return qtrace(3, 700)


@pytest.mark.parametrize("chunk", [64, 333, 2000])
def test_chunked_equals_monolithic(ref, chunk_trace, chunk):
    """Window indices are global: a chunk that divides the window (64 of
    128), one that does not (333) and one longer than the trace give the
    reference's monolithic windows, static and with failures."""
    tr = chunk_trace
    for fails in (None, mid_windows(tr)):
        scn = [het4(mod, "least_loaded", failures=fails, telemetry=128)
               for mod in (ref, T)]
        r = ref.simulate(scn[0], tr)
        p = T.simulate(scn[1], PortTrace(*tr), chunk_events=chunk,
                       device="cpu")
        assert_bitwise(r, p, (chunk, fails is not None))


# ---------------------------------------------------------------------------
# the block runner (eager on the CPU) against the host loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def short_chained():
    from repro_torch.workloads import ChainConfig, chained_trace
    return chained_trace(ChainConfig(duration_s=60.0, seed=3)).head(40)


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
                (what, key, x, y)


def runner_counts(fn):
    before = dict(graphs.STATS)
    out = fn()
    return out, (graphs.STATS["blocks"] - before["blocks"],
                 graphs.STATS["eager_events"] - before["eager_events"],
                 graphs.STATS["captures"] - before["captures"])


@pytest.mark.parametrize("failing", [False, True], ids=["static", "failures"])
@pytest.mark.parametrize("mode", MODES)
def test_block_runner_matches_host_loop(short_chained, mode, failing):
    """Windows of 3 events end inside and at the edge of blocks of K = 4;
    with chains on, each block reads its chain rows from the runner's
    fixed state.  Every length (a part of a block, a block, blocks and a
    remainder) gives the host loop's node, outcome, window and chain
    arrays."""
    scn = T.Scenario.cluster(
        (256.0, 512.0), max_slots=8, routing="slack_aware",
        chains=T.Chains(slack=1.5), telemetry=3,
        failures=(((float(short_chained.t[2]), float(short_chained.t[9])
                    + 0.5, 0),) if failing else None))
    cfg = scn.to_cluster_config()
    for length in (1, K - 1, K, K + 1, 3 * K + 5):
        tr = short_chained.head(length)
        plan = scn.chains.compile(tr)
        want = engine._simulate_cluster(cfg, tr, "cpu", 0, mode, None,
                                        scn.failures, telemetry=3,
                                        chains=plan)
        got, (blocks, eager, captures) = runner_counts(
            lambda: engine._simulate_cluster(
                cfg, tr, "cpu", 0, mode, 1000, scn.failures, K,
                telemetry=3, chains=plan))
        np.testing.assert_array_equal(want[0].node, got[0].node)
        np.testing.assert_array_equal(want[0].outcome, got[0].outcome)
        assert_extras_equal(want[1], got[1], (mode, failing, length))
        assert (blocks, eager, captures) == (length // K, length % K, 0)


@pytest.mark.parametrize("mode", MODES)
def test_autoscaled_block_runner_matches_host_loop(short_chained, mode):
    """Epochs shorter than, equal to and longer than the block, with node
    scaling, an outage, telemetry and chains: the runner equals the host
    loop, retirements included."""
    tr = short_chained
    for epoch in (3, K, 5, 17):
        scn = T.Scenario.cluster(
            (300.0, 600.0, 900.0), small_frac=(0.8, 0.5, 0.6),
            unified=(False, True, False), routing="least_loaded",
            max_slots=8, telemetry=5, chains=T.Chains(deadline_s=4.0),
            failures=((float(tr.t[3]), float(tr.t[20]) + 0.5, 0),),
            autoscale=T.Autoscale(epoch_events=epoch, min_frac=0.3,
                                  max_frac=0.9, gain=0.3,
                                  spawn_drop_frac=0.2,
                                  retire_drop_frac=0.05, init_active=2))
        args = (scn.to_cluster_config(), scn.autoscale, tr, "cpu", 0, mode,
                scn.failures)
        kw = dict(telemetry=5, chains=scn.chains.compile(tr))
        want = engine._simulate_cluster_autoscale(*args, **kw)
        got = engine._simulate_cluster_autoscale(*args, K, **kw)
        for x, y in zip((want[0].node, want[0].outcome, want[1]),
                        (got[0].node, got[0].outcome, got[1])):
            np.testing.assert_array_equal(x, y, err_msg=f"{epoch}")
        assert_extras_equal(want[2], got[2], (mode, epoch))


def test_sink_window_ends():
    """The window-final events a span holds, for windows that divide the
    trace and a short last window."""
    sink = engine.TelSink(4, 10, 2, "cpu")
    assert sink.ends(0, 10) == [3, 7, 9]
    assert sink.ends(4, 8) == [7] and sink.ends(8, 9) == []
    assert sink.ends(9, 10) == [9] and sink.ends(2, 5) == [3]
    assert engine.TelSink(5, 10, 1, "cpu").ends(5, 10) == [9]
    assert [j for j in range(10) if sink.is_end(j)] == [3, 7, 9]


def test_runner_cache_key_holds_telemetry_and_chain_capacity():
    a = graphs.block_runner("cpu", 2, 8, "gather", False, K, tel=True,
                            chains=10)
    assert graphs.block_runner("cpu", 2, 8, "gather", False, K, tel=True,
                               chains=graphs.MIN_CHAIN_CAP) is a
    assert a.chain_cap == graphs.MIN_CHAIN_CAP and a.tel
    for kw in (dict(tel=False, chains=10), dict(tel=True, chains=0),
               dict(tel=True, chains=graphs.MIN_CHAIN_CAP + 1)):
        assert graphs.block_runner("cpu", 2, 8, "gather", False, K,
                                   **kw) is not a
    assert graphs.chain_capacity(0) == 0
    assert graphs.chain_capacity(1769) == 2048
    with pytest.raises(ValueError, match="capacity"):
        a.load(*engine._run_inputs(T.Scenario.cluster(
            (256.0, 512.0), max_slots=8).to_cluster_config(), "cpu"),
            deadline=torch.zeros(a.chain_cap + 1))


# ---------------------------------------------------------------------------
# totals, the knob, the off switch
# ---------------------------------------------------------------------------

def test_window_sums_match_summary_totals(dyn_trace):
    res = T.simulate(dynamic(T, "both", dyn_trace), PortTrace(*dyn_trace),
                     device="cpu")
    tel, s = res.timeline(), res.summary()
    assert len(tel) == T.Telemetry(64).n_windows(len(dyn_trace)) \
        == s["n_windows"]
    assert int(tel.counts.sum()) == s["total"] == len(dyn_trace)
    pc = res.per_class()
    for c, m in ((0, pc.small), (1, pc.large)):
        assert int(tel.counts[:, c, 0].sum()) == m.hits
        assert int(tel.counts[:, c, 1].sum()) == m.misses
        assert int(tel.counts[:, c, 2].sum()) == m.drops
    assert int(tel.invalidated.sum()) == res.n_invalidated > 0
    assert (tel.events[:-1] == 64).all() and tel.events.sum() == len(res)
    assert (tel.event_start == np.arange(len(tel)) * 64).all()
    assert (tel.t_start <= tel.t_end).all()
    assert len(tel.table()) == len(tel)


def test_knob_validation_and_sugar():
    assert T.Scenario.kiss(1024.0, telemetry=64).telemetry == T.Telemetry(64)
    assert (T.Scenario.kiss(1024.0, telemetry={"window_events": 32})
            .telemetry == T.Telemetry(32))
    assert T.Scenario.kiss(1024.0).telemetry is None
    for bad in (0, -5, 2.5):
        with pytest.raises(ValueError):
            T.Telemetry(window_events=bad)
    for bad in (True, "64", 2.0):
        with pytest.raises(ValueError, match="telemetry"):
            T.Scenario.kiss(1024.0, telemetry=bad)
    assert T.Telemetry(64).n_windows(450) == 8
    assert T.Telemetry(64).n_windows(448) == 7
    assert hash(het4(T)) == hash(het4(T))


def test_no_telemetry_is_off():
    tr = PortTrace(*qtrace(7, 120))
    off = T.simulate(het4(T, telemetry=None), tr, device="cpu")
    assert off.telemetry is None and off.summary()["n_windows"] == 0
    with pytest.raises(ValueError, match="telemetry"):
        off.timeline()
    on = T.simulate(het4(T), tr, device="cpu")
    np.testing.assert_array_equal(off.outcome, on.outcome)
    np.testing.assert_array_equal(off.node, on.node)


# ---------------------------------------------------------------------------
# trace events and manifests
# ---------------------------------------------------------------------------

def test_trace_events_equal_reference(ref, dyn_trace, tmp_path):
    """Counter tracks, outage durations and the autoscaler's spawn,
    retire and re-split instants: the reference's dict, key for key."""
    asc = dict(NODE_ASC, spawn_drop_frac=0.005, retire_drop_frac=0.001)
    scn = [het4(mod, "size_aware", failures=mid_windows(dyn_trace),
                autoscale=mod.Autoscale(**asc)) for mod in (ref, T)]
    want = ref.simulate(scn[0], dyn_trace).to_trace_events()
    path = tmp_path / "run.trace.json"
    got = T.simulate(scn[1], PortTrace(*dyn_trace),
                     device="cpu").to_trace_events(str(path))
    assert got == want
    assert json.loads(path.read_text()) == got
    phases = {e["ph"] for e in got["traceEvents"]}
    assert phases == {"M", "C", "X", "i"}


def test_manifest_equals_reference(ref, chunk_trace, tmp_path):
    """The manifest is the reference's but for the versions (torch and
    CUDA, not JAX) and the run's engine and device."""
    from repro_torch.sim.telemetry import write_manifest
    tr = chunk_trace
    scn = [het4(mod, "least_loaded", failures=mid_windows(tr))
           for mod in (ref, T)]
    want = ref.simulate(scn[0], tr, chunk_events=128).manifest()
    got = T.simulate(scn[1], PortTrace(*tr), chunk_events=128,
                     device="cpu").manifest()
    assert set(got) == set(want)
    for key in set(got) - {"versions", "run"}:
        assert got[key] == want[key], key
    run = dict(got["run"])
    assert run.pop("engine") == "torch" and run.pop("device") == "cpu"
    assert run == {k: v for k, v in want["run"].items() if k != "engine"}
    v = got["versions"]
    assert {"python", "torch", "cuda", "numpy", "platform"} == set(v)
    assert v["torch"] == torch.__version__ and "jax" not in v
    path = write_manifest(got, str(tmp_path / "m.json"))
    assert json.loads(open(path).read())["scenario"] == got["scenario"]


def test_telemetry_goldens_are_the_references(ref):
    """``chip_smoke.py``'s telemetry phase holds the card to
    ``GOLDEN_TEL``: the reference's own results (``gather``) for the same
    scenarios on the stored quickstart trace."""
    from repro.core.types import Trace as RefTrace
    from repro_torch.workloads import quickstart_trace
    from test_torch_sim import _chip_smoke
    smoke = _chip_smoke()
    trace = quickstart_trace()
    scns = smoke.telemetry_scenarios(trace)
    assert set(scns) == set(smoke.GOLDEN_TEL)
    for name, scn in scns.items():
        r = ref.simulate(to_ref(ref, scn), RefTrace(*trace))
        assert r.scenario.label == scn.label
        assert smoke.tel_digests(r) == smoke.GOLDEN_TEL[name], name


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


def _card_scenario(tr, variant):
    t_end = float(tr.t[-1])
    fails = ((0.2 * t_end, 0.5 * t_end, 0), (0.4 * t_end, 0.8 * t_end, 2))
    kw = dict(routing="size_aware", replacement="greedy_dual",
              max_slots=64, telemetry=graphs.BLOCK_EVENTS + 5)
    if variant != "static":
        kw["failures"] = fails
    if variant == "autoscaled":
        kw["autoscale"] = dict(epoch_events=2 * graphs.BLOCK_EVENTS + 3,
                               min_frac=0.3, max_frac=0.9, gain=0.3,
                               spawn_drop_frac=0.1, retire_drop_frac=0.02,
                               init_active=2)
    return T.Scenario.cluster((512.0, 1024.0, 2048.0),
                              small_frac=(0.8, 0.5, 0.7),
                              unified=(False, True, False), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["static", "failures", "autoscaled"])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_telemetry_replay_matches_cpu(mode, variant):
    """Graph replay with telemetry (windows of K + 5 events, which end
    inside blocks) equals the CPU's host loop bitwise, monolithic and
    chunked, under ``set_sync_debug_mode("error")``; the runner's counts
    and B1's launches are as stated."""
    _card()
    k = graphs.BLOCK_EVENTS
    tr = _card_trace(3 * (2 * k + 3) + 20)
    scn = _card_scenario(tr, variant)
    cpu = T.simulate(scn, tr, mode=mode, device="cpu")
    chunks = (None,) if variant == "autoscaled" else (None, 2 * k + 3)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for chunk in chunks:
            b1 = evict_place_cuda.launches
            got, (blocks, eager, _) = runner_counts(
                lambda: T.simulate(scn, tr, mode=mode, chunk_events=chunk,
                                   device="cuda"))
            spans = ([len(tr)] if chunk is None and variant != "autoscaled"
                     else [2 * k + 3] * 3 + [20])
            assert (blocks, eager) == (sum(c // k for c in spans),
                                       sum(c % k for c in spans))
            assert evict_place_cuda.launches - b1 \
                == (len(tr) if mode == "fused" else 0)
            assert_bitwise(cpu, got, (mode, variant, chunk))
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_cuda_second_trace_length_replays_the_cached_graph():
    """The window arrays are not in the graph: a second trace of another
    length (so another window count) on the same cluster makes no new
    capture and still equals the CPU."""
    _card()
    first = _card_trace(2 * graphs.BLOCK_EVENTS + 9, seed=3)
    scn = _card_scenario(first, "failures")
    T.simulate(scn, first, mode="vmap", device="cuda")
    captures = graphs.STATS["captures"]
    second = _card_trace(5 * graphs.BLOCK_EVENTS + 2, seed=4)
    got = T.simulate(scn, second, mode="vmap", device="cuda")
    assert graphs.STATS["captures"] == captures
    assert_bitwise(T.simulate(scn, second, mode="vmap", device="cpu"), got)
