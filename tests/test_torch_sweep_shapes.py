"""Sweep groups of every other run shape in the PyTorch port against the
reference ``repro.sim.sweep`` and the port's ``simulate``, bitwise, and
the lane axis under them.

On the CPU, on short traces and small clusters: autoscaled groups, with
and without failures, whose lanes differ in every autoscaler parameter
(split bounds, gain, node-scaling thresholds, initial membership); chain
groups whose lanes differ in routing and deadlines (none, absolute,
slack), with an outage and telemetry; resize groups mixing the
``static`` and ``fair_share`` codes and floors; each in every step mode,
monolithic and chunked where the reference allows it.  The block runner
with lanes, eagerly at K = 4, against the host loop (static with
failures, telemetry and chains; autoscaled); every registered routing
body and a test-registered one through the lane spelling of
:mod:`repro_torch.core.xp` against the 1-D spelling and numpy, lane by
lane; and B1's wrapper at a sweep group's rows.  The static, failure and
telemetry groups and the refusals are in ``tests/test_torch_sweep.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.sim as T
from repro_torch.cluster import engine, graphs
from repro_torch.core import xp
from repro_torch.core.registry import ROUTING, RouteCtx
from repro_torch.core.types import Trace as PortTrace
from repro_torch.workloads import ChainConfig, chained_trace
from test_torch_sweep import assert_bitwise, check_lanes, windows

MODES = ("gather", "vmap", "fused")
N_EVENTS = 400
EPOCH = 96
K = 4


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def qtrace():
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(8), N_EVENTS)


@pytest.fixture(scope="module")
def ctr():
    """A short chained trace (``tests/test_chains.py``'s draw)."""
    return chained_trace(ChainConfig(duration_s=200.0, seed=3)).head(160)


def asc_lanes(mod, tr=None):
    """Five autoscaled lanes of one group: one epoch length, every other
    autoscaler parameter per lane; with ``tr``, each with its own
    outages."""
    a = mod.Autoscale
    specs = [
        ((1024.0, 2048.0, 768.0), "size_aware",
         a(epoch_events=EPOCH, gain=0.2)),
        ((1024.0, 1024.0, 1024.0), "least_loaded",
         a(epoch_events=EPOCH, min_frac=0.3, max_frac=0.95, gain=0.5)),
        ((2048.0, 512.0, 1536.0), "sticky",
         a(epoch_events=EPOCH, gain=0.1, spawn_drop_frac=0.02,
           retire_drop_frac=0.005, init_active=2)),
        ((768.0, 1024.0, 2048.0), "cost_model",
         a(epoch_events=EPOCH, min_frac=0.5, max_frac=0.7, gain=0.3,
           spawn_drop_frac=0.05, retire_drop_frac=0.01, init_active=1)),
        ((1024.0, 768.0, 1536.0), "power_of_two",
         a(epoch_events=EPOCH, gain=0.0, spawn_drop_frac=0.5,
           retire_drop_frac=0.4, init_active=3))]
    out = []
    for i, (mb, routing, asc) in enumerate(specs):
        out.append(mod.Scenario.cluster(
            mb, routing=routing, max_slots=24, autoscale=asc,
            unified=(False, i == 1, False), name=f"asc{i}",
            small_frac=0.6 if i == 3 else 0.8,
            failures=None if tr is None else mod.Failures(windows(tr, i))))
    return out


def chain_lanes(mod, tr):
    """Chain lanes: a routing x deadline grid with an outage on node 1
    and telemetry, one group."""
    t = np.asarray(tr.t)
    out = ((float(t[len(t) // 4]), float(t[2 * len(t) // 3]), 1),)
    regimes = ({}, {"deadline_s": 6.0}, {"slack": 2.0})
    return [mod.Scenario.cluster(
        (2000.0, 1000.0, 3000.0), routing=r, max_slots=32,
        chains=mod.Chains(**kw), failures=out, telemetry=40,
        name=f"{r}-{i}")
        for r in ("slack_aware", "size_aware", "least_loaded")
        for i, kw in enumerate(regimes)]


def resize_lanes(mod):
    """Resize lanes of one group: the ``static`` and ``fair_share``
    codes, floors from 0 to 48 MB, KiSS and unified nodes."""
    rz = mod.Resize
    c = mod.Scenario.cluster
    return [c((768.0, 1024.0), routing="size_aware", max_slots=32,
              resize=rz("fair_share", min_mb=0.0)),
            c((768.0, 1024.0), routing="size_aware", max_slots=32,
              resize="static"),
            c((1024.0, 512.0), routing="least_loaded", max_slots=32,
              unified=True, resize=rz("fair_share", min_mb=48.0)),
            c((512.0, 1024.0), routing="sticky", max_slots=32,
              replacement="greedy_dual", resize=rz("fair_share",
                                                   min_mb=16.0))]


def sweep_ref(ref, tr, scns, **kw):
    from repro.core.types import Trace as RefTrace
    return ref.sweep(RefTrace(*tr), scns, **kw)


@pytest.fixture(scope="module")
def ref_runs(ref, qtrace, ctr):
    return {"asc": sweep_ref(ref, qtrace, asc_lanes(ref)),
            "asc_failures": sweep_ref(ref, qtrace, asc_lanes(ref, qtrace)),
            "chains": sweep_ref(ref, ctr, chain_lanes(ref, ctr)),
            "resize": sweep_ref(ref, qtrace, resize_lanes(ref))}


def port_lanes(kind, qtrace, ctr):
    if kind == "asc":
        return asc_lanes(T), qtrace
    if kind == "asc_failures":
        return asc_lanes(T, qtrace), qtrace
    if kind == "chains":
        return chain_lanes(T, ctr), ctr
    return resize_lanes(T), qtrace


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["asc", "asc_failures", "chains",
                                  "resize"])
def test_sweep_matches_reference(kind, mode, ref_runs, qtrace, ctr):
    """Each lane of an autoscaled, chain or resize group equals the
    reference's sweep lane in every mode (``fracs``, ``active``,
    ``epoch_t``, the per-chain and window arrays, the vertical totals)."""
    scns, tr = port_lanes(kind, qtrace, ctr)
    got = T.sweep(PortTrace(*tr), scns, mode=mode, device="cpu")
    check_lanes(ref_runs[kind], got, (kind, mode))
    if kind.startswith("asc"):
        assert all(r.fracs.shape == (-(-N_EVENTS // EPOCH), 3) for r in got)
        assert len({r.n_active.min() for r in got}) > 1


@pytest.mark.parametrize("kind,mode,chunk", [
    ("chains", "fused", 37), ("chains", "gather", 64),
    ("resize", "vmap", 101), ("resize", "fused", 33)])
def test_chunked_matches_reference(kind, mode, chunk, ref_runs, qtrace,
                                   ctr):
    scns, tr = port_lanes(kind, qtrace, ctr)
    got = T.sweep(PortTrace(*tr), scns, mode=mode, chunk_events=chunk,
                  device="cpu")
    check_lanes(ref_runs[kind], got, (kind, mode, chunk))


@pytest.mark.parametrize("kind,mode", [("asc_failures", "fused"),
                                       ("chains", "vmap"),
                                       ("resize", "gather")])
def test_each_lane_is_its_simulate(kind, mode, qtrace, ctr):
    scns, tr = port_lanes(kind, qtrace, ctr)
    tr = PortTrace(*tr)
    got = T.sweep(tr, scns, mode=mode, device="cpu")
    check_lanes([T.simulate(s, tr, mode=mode, device="cpu") for s in scns],
                got, (kind, mode))


def test_chain_lanes_read_their_own_deadlines(ref_runs):
    """Lanes that differ only in their deadlines route differently under
    ``slack_aware`` (each lane's slack is its own), and the deadline
    regimes miss differently."""
    res = ref_runs["chains"]
    none, dl, slack = res[0], res[1], res[2]
    assert none.summary()["deadline_miss_pct"] \
        < slack.summary()["deadline_miss_pct"]
    assert not np.array_equal(none.node, slack.node) \
        or not np.array_equal(none.node, dl.node)


# ---------------------------------------------------------------------------
# the block runner with lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_block_runner_with_lanes_matches_host_loop(mode, ctr):
    """Chunks that split blocks (K = 4, chunks of 37: nine blocks and an
    eager event each), lanes with failures, telemetry and chains: the
    runner equals the host loop and counts the blocks and eager events
    of every chunk, whatever the lane count."""
    scns = chain_lanes(T, ctr)
    tr = PortTrace(*ctr)
    cfgs = [s.to_cluster_config() for s in scns]
    plans = [s.chains.compile(tr) for s in scns]
    fails = [s.failures for s in scns]
    want = engine._sweep_cluster_failures(tr, cfgs, fails, mode=mode,
                                          telemetry=40, chains=plans,
                                          device="cpu")
    before = dict(graphs.STATS)
    got = engine._sweep_cluster_chunked(tr, cfgs, mode=mode,
                                        chunk_events=37, failures=fails,
                                        telemetry=40, chains=plans,
                                        device="cpu", block_events=K)
    spans = [min(37, len(tr) - s) for s in range(0, len(tr), 37)]
    assert graphs.STATS["blocks"] - before["blocks"] \
        == sum(c // K for c in spans)
    assert graphs.STATS["eager_events"] - before["eager_events"] \
        == sum(c % K for c in spans)
    for (w, wx), (g, gx) in zip(want, got):
        np.testing.assert_array_equal(w.node, g.node)
        np.testing.assert_array_equal(w.outcome, g.outcome)
        for key in ("telemetry", "chains"):
            for k in wx[key]:
                assert np.asarray(wx[key][k]).tobytes() \
                    == np.asarray(gx[key][k]).tobytes(), (key, k)
        np.testing.assert_array_equal(wx["invalidated"], gx["invalidated"])
    runner = graphs.block_runner("cpu", 3, 32, mode, True, K, tel=True,
                                 chains=plans[0].n_chains, lanes=len(scns))
    assert runner.lanes == len(scns) and runner.node.shape == (K, len(scns))
    assert runner.pools.valid.shape == (len(scns) * 6, 32)


@pytest.mark.parametrize("mode", ["gather", "fused"])
def test_autoscaled_block_runner_with_lanes_matches_host_loop(mode,
                                                              qtrace):
    tr = PortTrace(*qtrace)
    scns = asc_lanes(T, qtrace)
    args = ([s.to_cluster_config() for s in scns],
            [s.autoscale for s in scns], [s.failures for s in scns])
    want = engine._sweep_cluster_autoscale(tr, *args, mode=mode,
                                           device="cpu")
    got = engine._sweep_cluster_autoscale(tr, *args, mode=mode,
                                          device="cpu", block_events=K)
    for (w, wf, wx), (g, gf, gx) in zip(want, got):
        np.testing.assert_array_equal(w.outcome, g.outcome)
        np.testing.assert_array_equal(wf, gf)
        np.testing.assert_array_equal(wx["active"], gx["active"])
        np.testing.assert_array_equal(wx["invalidated"], gx["invalidated"])


def test_runner_cache_key_holds_the_lane_count():
    a = graphs.block_runner("cpu", 2, 8, "gather", False, K)
    b = graphs.block_runner("cpu", 2, 8, "gather", False, K, lanes=3)
    assert a is not b and a.lanes == 1 and b.lanes == 3
    assert graphs.block_runner("cpu", 2, 8, "gather", False, K,
                               lanes=3) is b
    assert b.routing.shape == (3,) and b.unified.shape == (3, 2)
    assert b.cloud.shape == (3, 2) and b.up.shape == (K, 3, 2)
    with pytest.raises(ValueError, match="lanes"):
        graphs.BlockRunner(torch.device("cpu"), 2, 8, "gather", False, K,
                           lanes=0)


# ---------------------------------------------------------------------------
# the lane spelling of the routing bodies
# ---------------------------------------------------------------------------

def _fullest_fit(xp, ctx):
    """A test policy on every lane-sensitive spelling: the up node that
    can host the container with the lowest free fraction if below one
    half, else the first such node, else the sticky hash."""
    frac = ctx.free / xp.maximum(ctx.cap, xp.float32(1e-6))
    fits = (ctx.cap >= ctx.size) & ctx.node_up
    k = xp.sum(fits.astype(xp.int32))
    masked = xp.where(fits, frac, xp.float32(xp.inf))
    best = xp.argmin(masked)
    first = xp.argmax(xp.cumsum(fits.astype(xp.int32)) == 1)
    return xp.where(k == 0, ctx.h1,
                    xp.where(masked[best] < xp.float32(0.5), best, first))


@pytest.fixture
def port_routing_registry():
    """Roll back any routing policy a test registers in the port (the
    conftest fixture does it for the reference)."""
    specs, by_name = list(ROUTING._specs), dict(ROUTING._by_name)
    yield
    ROUTING._specs[:] = specs
    ROUTING._by_name.clear()
    ROUTING._by_name.update(by_name)


def _ctx_arrays(rng, lanes, n):
    """Random ctx arrays with ties (free and capacity on a 64 MB grid),
    a lane with every node down and a lane with no slack."""
    cap = (rng.integers(0, 6, (lanes, n)) * 256).astype(np.float32)
    free = np.minimum(rng.integers(0, 5, (lanes, n)) * 64.0,
                      cap).astype(np.float32)
    up = rng.random((lanes, n)) < 0.7
    up[1] = False
    slack = rng.integers(-2, 6, (lanes, 1)).astype(np.float32)
    slack[2] = 0.0
    return dict(free=free, cap=cap, node_up=up, chain_slack=slack,
                cloud_rtt_s=rng.integers(1, 8, (lanes, 1)).astype(
                    np.float32) / 8,
                cloud_cold_prob=rng.integers(0, 5, (lanes, 1)).astype(
                    np.float32) / 4)


def test_every_routing_body_runs_lane_by_lane(port_routing_registry):
    """Every registered routing body (and one registered here) answers
    on ``[L, N]`` ctx arrays what it answers, lane by lane, on the 1-D
    spelling and on numpy: the reductions, ``cumsum``, ``argmax``/
    ``argmin`` (first index on ties) and ``a[i]`` at a 0-d or ``[L, 1]``
    index act along the last axis."""
    T.register_routing("fullest_fit")(_fullest_fit)
    rng = np.random.default_rng(4)
    lanes, n = 6, 5
    for trial in range(8):
        arr = _ctx_arrays(rng, lanes, n)
        ev = dict(h1=np.int32(rng.integers(0, n)),
                  h2=np.int32(rng.integers(0, n)),
                  size=np.float32(rng.integers(1, 5) * 128.0),
                  cls=np.int32(rng.integers(0, 2)),
                  warm=np.float32(rng.integers(1, 9) / 8),
                  cold=np.float32(rng.integers(9, 40) / 8),
                  chain_stage=np.int32(rng.integers(-1, 3)))
        tev = {k: torch.tensor(v) for k, v in ev.items()}
        lane_ctx = RouteCtx(**tev, **{
            k: xp.asx(torch.tensor(v)) for k, v in arr.items()})
        for spec in ROUTING.specs():
            got = spec.fn(xp, lane_ctx)
            got = torch.broadcast_to(got, (lanes, 1))
            for g in range(lanes):
                one = RouteCtx(**tev, **{
                    k: (xp.asx(torch.tensor(v[g])) if v.shape[1] > 1
                        else torch.tensor(v[g, 0]))
                    for k, v in arr.items()})
                scalar = spec.fn(xp, one)
                host = spec.fn(np, RouteCtx(**ev, **{
                    k: (v[g] if v.shape[1] > 1 else v[g, 0])
                    for k, v in arr.items()}))
                assert scalar.ndim == 0, spec.name
                assert int(got[g, 0]) == int(scalar) == int(host), \
                    (spec.name, trial, g)


def test_lane_spelling_reductions():
    """The spellings one by one, against numpy row by row."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 3, (4, 7)).astype(np.float32)
    t = xp.asx(torch.tensor(a))
    np.testing.assert_array_equal(xp.sum(t).numpy(), a.sum(-1,
                                                           keepdims=True))
    np.testing.assert_array_equal(xp.cumsum(t).numpy(), np.cumsum(a, -1))
    for f, g in ((xp.argmax, np.argmax), (xp.argmin, np.argmin)):
        np.testing.assert_array_equal(f(t).numpy()[:, 0],
                                      [g(row) for row in a])
        b = t > 1
        np.testing.assert_array_equal(f(b).numpy()[:, 0],
                                      [g(row > 1) for row in a])
    idx = xp.argmin(t)
    np.testing.assert_array_equal(t[idx].numpy()[:, 0], a.min(-1))
    np.testing.assert_array_equal(t[torch.tensor(3)].numpy()[:, 0], a[:, 3])
    one = xp.asx(torch.tensor(a[0]))
    assert xp.sum(one).ndim == 0 and xp.argmax(one).ndim == 0
    assert one[torch.tensor(2)].ndim == 0
    plain = torch.tensor(a)                   # numpy's whole-array rules
    assert float(xp.sum(plain)) == a.sum()
    assert int(xp.argmax(plain)) == int(np.argmax(a))


def test_registered_routing_sweeps_like_the_reference(
        ref, qtrace, port_routing_registry):
    """A routing policy registered in both packages with one body sweeps
    each lane bitwise as the reference's lane, in a group whose other
    lanes run other policies (codes are per-lane data)."""
    ref.register_routing("fullest_fit")(_fullest_fit)
    T.register_routing("fullest_fit")(_fullest_fit)

    def lanes(mod):
        return [mod.Scenario.cluster((768.0, 1024.0, 2048.0), routing=r,
                                     max_slots=24)
                for r in ("fullest_fit", "size_aware", "fullest_fit")]
    want = sweep_ref(ref, qtrace, lanes(ref))
    got = T.sweep(PortTrace(*qtrace), lanes(T), mode="fused", device="cpu")
    check_lanes(want, got, "fullest_fit")
    assert not np.array_equal(got[0].node, got[1].node)


# ---------------------------------------------------------------------------
# B1 at a sweep group's rows
# ---------------------------------------------------------------------------

def test_fused_step_counts_rows_not_lanes(qtrace, monkeypatch):
    """In ``fused`` the step calls the step backend once an event for
    every lane's pools at once: ``[L * 2N, S]`` rows."""
    from repro_torch.core import pool
    calls = []
    real = pool.get_step_backend("fused")

    def counting(pri, *rest):
        calls.append(tuple(pri.shape))
        return real(pri, *rest)
    monkeypatch.setitem(pool._STEP_BACKENDS, "fused", counting)
    scns = [T.Scenario.kiss(m * 1024.0, max_slots=16) for m in (1, 2, 3)]
    T.sweep(PortTrace(*qtrace).head(20), scns, mode="fused", device="cpu")
    assert calls == [(6, 16)] * 20


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_sweep_on_the_card_equals_the_cpu(mode):
    """On the card every group runs through the block runner's CUDA
    graphs with its lanes as a tensor axis: each lane equals the CPU
    sweep's, monolithic and chunked, static with failures and
    autoscaled, and B1 launches once a ``fused`` event of a group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    from repro_torch.kernels.pool_step import evict_place_cuda
    from repro_torch.workloads import quickstart_trace
    from test_torch_sweep import failure_lanes
    tr = quickstart_trace().head(300)
    for scns, chunk in ((failure_lanes(T, tr), None),
                        (failure_lanes(T, tr), 100),
                        (asc_lanes(T, tr), None)):
        before = evict_place_cuda.launches
        got = T.sweep(tr, scns, mode=mode, chunk_events=chunk)
        assert evict_place_cuda.launches - before \
            == (len(tr) if mode == "fused" else 0)
        want = T.sweep(tr, scns, mode=mode, chunk_events=chunk,
                       device="cpu")
        check_lanes(want, got, (mode, chunk))
        assert {r.run_info["device"] for r in got} == {"cuda"}
