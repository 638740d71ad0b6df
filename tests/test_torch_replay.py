"""Chunked replay and the block runner of the PyTorch port.

On the CPU, against the reference ``repro.sim`` on quantized traces,
bitwise: chunked == monolithic for chunk sizes that do and do not divide
the trace, chunked == the reference's chunked run in every step mode,
chunked failure runs, ``chunk_events`` validation, a tiny trace, and the
``Trace`` slicers.  The block runner (run eagerly on the CPU) against
the host loop at lengths around its block.  On the card (``cuda``):
graph replay == the CPU's loop, the graph cache, the counters, and a
capture that fails raising.  The reference (and ``conftest``, which
imports it) is reached through fixtures, so the file also collects where
JAX is absent (the GPU host).
"""
import numpy as np
import pytest
import torch

import repro_torch.sim as T
from repro_torch.cluster import engine, graphs
from repro_torch.core.types import Trace as PortTrace
from repro_torch.kernels.pool_step import evict_place_cuda

CLUSTER = (256.0, 512.0, 1024.0)
MODES = ("gather", "vmap", "fused")


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def qtrace():
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(0), 2000)


def cluster(mod, routing="size_aware", **kw):
    return mod.Scenario.cluster(CLUSTER, routing=routing, max_slots=32,
                                **kw)


def windows(tr):
    """The outage windows of the reference's chunked failure test."""
    t_end = float(np.asarray(tr.t)[-1])
    return ((0.2 * t_end, 0.5 * t_end, 0), (0.4 * t_end, 0.8 * t_end, 2))


def assert_same(a, b, what=""):
    """Bitwise per event and on every summary key; with failures also
    ``invalidated`` and ``node_up``."""
    np.testing.assert_array_equal(np.asarray(a.node), b.node, err_msg=what)
    np.testing.assert_array_equal(np.asarray(a.outcome), b.outcome,
                                  err_msg=what)
    np.testing.assert_array_equal(np.asarray(a.latencies), b.latencies,
                                  err_msg=what)
    assert a.summary() == b.summary(), what
    for f in ("invalidated", "node_up"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def mono(qtrace):
    return T.simulate(cluster(T), PortTrace(*qtrace), device="cpu")


def test_monolithic_matches_reference(ref, qtrace, mono):
    assert_same(ref.simulate(cluster(ref), qtrace), mono)


@pytest.mark.parametrize("chunk", [64, 333, 2000, 4096])
def test_chunked_equals_monolithic(qtrace, mono, chunk):
    """Chunk sizes that do and do not divide the length, equal to it and
    longer than it all give the monolithic run bit for bit."""
    got = T.simulate(cluster(T), PortTrace(*qtrace), chunk_events=chunk,
                     device="cpu")
    assert_same(mono, got, chunk)
    assert got.run_info["chunk_events"] == chunk


@pytest.fixture(scope="module")
def ref_chunked(ref, qtrace):
    """The reference's chunked ``gather`` run (its modes are bitwise
    equal to one another, by its own tests)."""
    return ref.simulate(cluster(ref, "least_loaded"), qtrace,
                        chunk_events=256)


@pytest.mark.parametrize("mode", MODES)
def test_chunked_matches_reference(qtrace, ref_chunked, mode):
    got = T.simulate(cluster(T, "least_loaded"), PortTrace(*qtrace),
                     chunk_events=256, mode=mode, device="cpu")
    assert_same(ref_chunked, got, mode)


def test_chunked_failures(ref, qtrace):
    """The reference's chunked failure case: chunked == monolithic ==
    the reference, with ``invalidated`` and ``node_up``."""
    tr = PortTrace(*qtrace)
    scn = cluster(T, "least_loaded", failures=windows(qtrace))
    mono = T.simulate(scn, tr, device="cpu")
    assert mono.n_invalidated > 0
    for chunk in (100, 777):
        assert_same(mono, T.simulate(scn, tr, chunk_events=chunk,
                                     device="cpu"), chunk)
    assert_same(ref.simulate(cluster(ref, "least_loaded",
                                     failures=windows(qtrace)), qtrace),
                mono)


def test_chunk_events_validation(qtrace):
    tr = PortTrace(*qtrace).head(50)
    scn = T.Scenario.kiss(512.0, max_slots=32)
    for bad in (0, -5, 2.5, "x"):
        with pytest.raises(ValueError, match="chunk_events"):
            T.simulate(scn, tr, chunk_events=bad, device="cpu")


def test_chunked_accepts_tiny_trace(ref):
    n = 5
    arrays = dict(t=np.arange(n, dtype=np.float32),
                  func_id=np.zeros(n, np.int32),
                  size_mb=np.full(n, 64, np.float32),
                  cls=np.zeros(n, np.int32),
                  warm_dur=np.ones(n, np.float32),
                  cold_dur=np.full(n, 2, np.float32))
    tr = PortTrace(**arrays)
    scn = T.Scenario.kiss(256.0, max_slots=8)
    got = T.simulate(scn, tr, chunk_events=64, device="cpu")
    assert_same(T.simulate(scn, tr, device="cpu"), got)
    from repro.core.types import Trace as RefTrace
    assert_same(ref.simulate(ref.Scenario.kiss(256.0, max_slots=8),
                             RefTrace(**arrays)), got)


SLICERS = {
    "replace": lambda tr: tr.replace(size_mb=tr.size_mb * 2),
    "sorted_by_time": lambda tr: tr.replace(t=tr.t[::-1]).sorted_by_time(),
    "select": lambda tr: tr.select(tr.cls == 1),
    "window": lambda tr: tr.window(600.0, 1800.0),
    "shifted": lambda tr: tr.window(600.0, 1800.0).shifted(),
}


@pytest.mark.parametrize("name", sorted(SLICERS))
def test_trace_slicers_match_reference(qtrace, name):
    """Each slicer gives the reference's arrays, with and without the
    chain fields, and the same errors."""
    from repro.core.types import Trace as RefTrace
    n = len(qtrace)
    chains = dict(chain_id=np.arange(n, dtype=np.int32) // 3,
                  stage=np.arange(n, dtype=np.int32) % 3,
                  chain_len=np.full(n, 3, np.int32))
    for extra in ({}, chains):
        fields = dict(qtrace._asdict(), **extra)
        want = SLICERS[name](RefTrace(**fields))
        got = SLICERS[name](PortTrace(**fields))
        assert type(got) is PortTrace and len(got) == len(want) > 0
        for f, a, b in zip(want._fields, want, got):
            if a is None:
                assert b is None, f
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
    with pytest.raises(ValueError, match="no field"):
        PortTrace(*qtrace).replace(bogus=1)
    with pytest.raises(ValueError, match="t0 <= t1"):
        PortTrace(*qtrace).window(2.0, 1.0)


# ---------------------------------------------------------------------------
# the block runner, run eagerly on the CPU
# ---------------------------------------------------------------------------

K = 4


@pytest.fixture(scope="module")
def short_trace():
    rng = np.random.default_rng(7)
    n, q = 3 * K + 5, 64
    fid = rng.integers(0, 6, n).astype(np.int32)
    warm = rng.integers(1, 5 * q, n) / q
    return PortTrace(
        t=(np.sort(rng.integers(0, 40 * q, n)) / q).astype(np.float32),
        func_id=fid, size_mb=(40.0 + 60.0 * (fid % 3)).astype(np.float32),
        cls=np.zeros(n, np.int32), warm_dur=warm.astype(np.float32),
        cold_dur=(warm + 2.0).astype(np.float32))


@pytest.mark.parametrize("failing", [False, True], ids=["static", "failures"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("length", [1, K - 1, K, K + 1, 3 * K + 5])
def test_block_runner_matches_host_loop(short_trace, length, mode, failing):
    """A block of ``K`` events and the eager remainder, on one carry,
    give the host loop's results; the runner counts ``length // K``
    blocks and ``length % K`` eager events."""
    tr = short_trace.head(length)
    t = short_trace.t
    fails = (T.Failures(((float(t[2]), float(t[9]) + 0.5, 0),))
             if failing else None)
    cfg = T.Scenario.cluster((256.0, 512.0), max_slots=8,
                             routing="least_loaded").to_cluster_config()
    before = dict(graphs.STATS)
    if failing:
        want, want_x = engine._simulate_cluster_failures_torch(
            cfg, fails, tr, "cpu", mode=mode)
        got, got_x = engine._simulate_cluster_chunked_torch(
            cfg, tr, "cpu", mode=mode, chunk_events=1000, failures=fails,
            block_events=K)
        for f in ("invalidated", "node_up"):
            np.testing.assert_array_equal(want_x[f], got_x[f])
    else:
        want = engine._simulate_cluster_torch(cfg, tr, "cpu", mode=mode)
        got = engine._simulate_cluster_chunked_torch(
            cfg, tr, "cpu", mode=mode, chunk_events=1000, block_events=K)
    np.testing.assert_array_equal(want.node, got.node)
    np.testing.assert_array_equal(want.outcome, got.outcome)
    assert graphs.STATS["blocks"] - before["blocks"] == length // K
    assert (graphs.STATS["eager_events"] - before["eager_events"]
            == length % K)
    assert graphs.STATS["captures"] == before["captures"]   # CPU: none


def test_block_runner_partitions_each_chunk(short_trace):
    """Chunks of 7 events over 17 with K = 4: one block and three eager
    events for each full chunk, three eager for the last."""
    cfg = T.Scenario.cluster((256.0, 512.0), max_slots=8,
                             routing="least_loaded").to_cluster_config()
    want = engine._simulate_cluster_torch(cfg, short_trace, "cpu")
    before = dict(graphs.STATS)
    got = engine._simulate_cluster_chunked_torch(
        cfg, short_trace, "cpu", chunk_events=7, block_events=K)
    np.testing.assert_array_equal(want.node, got.node)
    np.testing.assert_array_equal(want.outcome, got.outcome)
    assert graphs.STATS["blocks"] - before["blocks"] == 2
    assert graphs.STATS["eager_events"] - before["eager_events"] == 9


def test_runner_cache_key_holds_the_registries():
    """A runner is reused for the same shape and mode, and a new one is
    made when the step would close over other policies."""
    a = graphs.block_runner("cpu", 2, 8, "gather", False, K)
    assert graphs.block_runner(torch.device("cpu"), 2, 8, "gather",
                               False, K) is a
    for other in ((3, 8, "gather", False), (2, 16, "gather", False),
                  (2, 8, "vmap", False), (2, 8, "gather", True)):
        assert graphs.block_runner("cpu", *other, K) is not a
    assert graphs.block_runner("cpu", 2, 8, "gather", False, K + 1) is not a
    with pytest.raises(ValueError, match="step backend"):
        graphs.block_runner("cpu", 2, 8, "scatter", False, K)


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
    large = rng.random(n) < 0.25
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


def _card_scenario(routing="size_aware", node_mb=(512.0, 1024.0, 2048.0),
                   failures=None):
    return T.Scenario.cluster(node_mb, small_frac=(0.8, 0.5, 0.7),
                              unified=(False, True, False), routing=routing,
                              replacement="greedy_dual", max_slots=64,
                              failures=failures)


@pytest.mark.cuda
@pytest.mark.parametrize("failing", [False, True], ids=["static", "failures"])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_graph_replay_matches_cpu(mode, failing):
    """Monolithic and chunked runs on the card (graph replays plus the
    eager remainder) equal the CPU's host loop bitwise, under
    ``set_sync_debug_mode("error")``; the runner's counts and B1's
    launches are one a block and event as stated."""
    _card()
    k = graphs.BLOCK_EVENTS
    tr = _card_trace(3 * k + 5)
    scn = _card_scenario(failures=windows(tr) if failing else None)
    cpu = T.simulate(scn, tr, mode=mode, device="cpu")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for chunk in (None, 2 * k + 3):
            before, b1 = dict(graphs.STATS), evict_place_cuda.launches
            got = T.simulate(scn, tr, mode=mode, chunk_events=chunk,
                             device="cuda")
            spans = [len(tr)] if chunk is None else [2 * k + 3, k + 2]
            assert graphs.STATS["blocks"] - before["blocks"] \
                == sum(c // k for c in spans)
            assert graphs.STATS["eager_events"] - before["eager_events"] \
                == sum(c % k for c in spans)
            assert evict_place_cuda.launches - b1 \
                == (len(tr) if mode == "fused" else 0)
            assert_same(cpu, got, (mode, chunk))
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_cuda_graph_cache_is_reused_across_runs():
    """A second scenario of the same shape, with another routing and
    other capacities, replays the cached graph (no new capture) and
    still equals the CPU."""
    _card()
    tr = _card_trace(2 * graphs.BLOCK_EVENTS + 9, seed=3)
    first = _card_scenario("size_aware")
    T.simulate(first, tr, mode="vmap", device="cuda")
    captures = graphs.STATS["captures"]
    for scn in (_card_scenario("least_loaded", (768.0, 512.0, 4096.0)),
                _card_scenario("cost_model", (300.0, 2048.0, 1024.0))):
        got = T.simulate(scn, tr, mode="vmap", device="cuda")
        assert graphs.STATS["captures"] == captures
        assert_same(T.simulate(scn, tr, mode="vmap", device="cpu"), got)


@pytest.mark.cuda
def test_cuda_capture_of_a_syncing_step_raises(monkeypatch):
    """A step that reads a device value back cannot be captured: making
    the runner raises, and no eager run takes its place."""
    _card()
    real = graphs._make_step

    def syncing(*args):
        step = real(*args)

        def step_and_sync(pools, ev, up_n=None):
            out = step(pools, ev, up_n)
            float(ev.t)                      # a host read: a sync
            return out
        return step_and_sync

    monkeypatch.setattr(graphs, "_make_step", syncing)
    with pytest.raises(RuntimeError):
        graphs.block_runner("cuda", 2, 8, "gather", False, 3)
    with pytest.raises(RuntimeError):        # nothing was cached
        graphs.block_runner("cuda", 2, 8, "gather", False, 3)
    torch.cuda.synchronize()


def test_chunked_goldens_are_the_references(ref):
    """``chip_smoke.py`` holds the card's chunked full-trace runs to
    ``GOLDEN_FULL``: the reference's own chunked results on the stored
    quickstart trace (the reference's ``edge_trace(seed=0,
    duration_s=3600)``, as ``test_torch_sim`` pins)."""
    from repro.cluster.presets import het16_cluster
    from repro.core.types import Trace as RefTrace
    from repro_torch.workloads import quickstart_trace
    from test_torch_sim import _chip_smoke, _digests
    smoke = _chip_smoke()
    tr = RefTrace(*quickstart_trace())
    ref_scn = {"kiss4096": ref.Scenario.kiss(4096.0),
               "het16_size_aware": ref.Scenario.from_cluster(
                   het16_cluster("size_aware"))}
    assert set(ref_scn) == set(smoke.GOLDEN_FULL)
    for name, scn in ref_scn.items():
        assert _digests(ref.simulate(scn, tr,
                                     chunk_events=smoke.CHUNK_EVENTS)) \
            == smoke.GOLDEN_FULL[name], name
