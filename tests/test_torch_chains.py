"""Function chains in the PyTorch port against the reference
``repro.sim``, bitwise.

On the CPU, on a short chained trace (``ChainConfig(duration_s=200.0,
seed=3)``, as ``tests/test_chains.py`` draws it): the per-chain
``latency``/``dropped``/``done``/``missed``/``deadline`` arrays, the four
chain summary keys and telemetry's ``chain_miss`` for every routing
(``slack_aware`` among them) x step mode x {``Chains()``, ``deadline_s``,
``slack``}, static and with a node outage, and one autoscaled case;
chunked == monolithic; ``slack_aware`` reading each event's real slack
(a tight SLO under an outage routes otherwise than no SLO); the
deadline semantics on a hand-built trace; a finished chunked result
keeping its arrays after the next run; the knob and its errors; the
port's ``chained_trace`` and its stored benchmark trace against the
reference's; and the JAX side of ``chip_smoke.GOLDEN_CHAIN``.  On the
card (``cuda``): the graph path == the CPU run.  The reference (and
``conftest``) is reached through fixtures, so the file also collects
where JAX is absent (the GPU host).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.sim as T
from repro_torch.cluster import graphs
from repro_torch.core.types import Trace as PortTrace
from repro_torch.workloads import (ChainConfig, benchmark_chained_trace,
                                   chained_trace)

MODES = ("gather", "vmap", "fused")
ROUTINGS = ("sticky", "least_loaded", "size_aware", "power_of_two",
            "cost_model", "slack_aware")
CLUSTER = (2000.0, 1000.0, 3000.0)
#: The SLO regimes: none (only drops miss), an absolute deadline, and
#: deadlines of twice each chain's all-warm path.
REGIMES = {"none": {}, "deadline": {"deadline_s": 6.0},
           "slack": {"slack": 2.0}}
N_EVENTS = 100
CHAIN_FIELDS = ("latency", "dropped", "done", "missed", "deadline")
CHAIN_KEYS = ("n_chains", "chain_latency_mean_s", "chain_p95_s",
              "deadline_miss_pct")


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def ctr():
    """The head of ``tests/test_chains.py``'s chained trace: 25 chains
    started, the last ones cut by the trace's end."""
    return chained_trace(ChainConfig(duration_s=200.0, seed=3)
                         ).head(N_EVENTS)


def outage(tr):
    """Node 1 down over the middle of the trace."""
    return ((float(tr.t[20]), float(tr.t[60]), 1),)


def scenario(mod, tr, routing, regime, kind, **kw):
    return mod.Scenario.cluster(
        CLUSTER, routing=routing, max_slots=64, telemetry=16,
        chains=mod.Chains(**REGIMES[regime]),
        failures=outage(tr) if kind == "failures" else None, **kw)


def assert_chains_equal(r, p, what=""):
    """Per-event outcomes, every per-chain array, the chain summary keys
    and telemetry's chain misses, bitwise (``latency`` f32 byte for
    byte)."""
    np.testing.assert_array_equal(r.node, p.node, err_msg=str(what))
    np.testing.assert_array_equal(r.outcome, p.outcome, err_msg=str(what))
    a, b = r.chain_metrics(), p.chain_metrics()
    for f in CHAIN_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
            (what, f, x, y)
    x, y = r.timeline().chain_miss, p.timeline().chain_miss
    assert x.dtype == y.dtype and np.array_equal(x, y), what
    sr, sp = r.summary(), p.summary()
    assert all(sr[k] == sp[k] for k in CHAIN_KEYS), what
    assert sr == sp, what


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_runs(ref, ctr):
    """The reference's ``gather`` run per (routing, regime, kind)."""
    cache = {}

    def run(*key):
        if key not in cache:
            cache[key] = ref.simulate(scenario(ref, ctr, *key), ctr)
        return cache[key]
    return run


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("routing", ROUTINGS)
def test_chains_match_reference(routing, mode, ctr, ref_runs):
    tr = PortTrace(*ctr)
    for regime in REGIMES:
        for kind in ("static", "failures"):
            p = T.simulate(scenario(T, tr, routing, regime, kind), tr,
                           mode=mode, device="cpu")
            assert_chains_equal(ref_runs(routing, regime, kind), p,
                                (routing, mode, regime, kind))
            cm = p.chain_metrics()
            assert 0 < cm.n_done < cm.n_chains          # some chains cut
            assert int(p.timeline().chain_miss.sum()) == int(cm.missed.sum())


def test_autoscaled_chains_match_reference(ref, ctr):
    """Node scaling with an outage, ``slack_aware``, every mode."""
    asc = dict(epoch_events=32, spawn_drop_frac=0.05,
               retire_drop_frac=0.01, init_active=2)
    r = ref.simulate(scenario(ref, ctr, "slack_aware", "slack", "failures",
                              autoscale=ref.Autoscale(**asc)), ctr)
    scn = scenario(T, ctr, "slack_aware", "slack", "failures",
                   autoscale=T.Autoscale(**asc))
    for mode in MODES:
        p = T.simulate(scn, PortTrace(*ctr), mode=mode, device="cpu")
        assert_chains_equal(r, p, mode)
        np.testing.assert_array_equal(r.fracs, p.fracs)
        np.testing.assert_array_equal(r.active, p.active)


@pytest.mark.parametrize("chunk", [37, 64])
def test_chunked_equals_monolithic(ref_runs, ctr, chunk):
    """Chain rows are global: chunks that split chains mid-flight give
    the reference's monolithic arrays, static and with the outage."""
    tr = PortTrace(*ctr)
    for kind in ("static", "failures"):
        p = T.simulate(scenario(T, tr, "slack_aware", "slack", kind), tr,
                       chunk_events=chunk, device="cpu")
        assert_chains_equal(ref_runs("slack_aware", "slack", kind), p,
                            (chunk, kind))


def test_chunked_result_keeps_its_arrays_after_the_next_run(ctr):
    """A chunked run on the CPU goes through the cached block runner,
    whose chain state the next run on it zeroes: a finished result's
    per-chain arrays are copies and do not move."""
    tr = PortTrace(*ctr)
    scn = T.Scenario.cluster(CLUSTER, max_slots=16, chains=T.Chains(
        slack=2.0))
    first = T.simulate(scn, tr, chunk_events=37, device="cpu")
    kept = {f: getattr(first.chain_metrics(), f).copy()
            for f in CHAIN_FIELDS}
    T.simulate(dataclasses.replace(scn, node_mb=(64.0,) * 3),
               tr.head(10), chunk_events=37, device="cpu")
    for f in CHAIN_FIELDS:
        np.testing.assert_array_equal(getattr(first.chain_metrics(), f),
                                      kept[f], err_msg=f)


def test_slack_aware_reads_the_slack(ref, ctr):
    """With ``Chains(slack=1.0)`` a chain's first cold start leaves no
    slack, and ``slack_aware`` sheds its later stages to the down node
    during the outage; with ``Chains()`` every slack is +inf and it
    routes as ``sticky``.  Both equal the reference."""
    tr = PortTrace(*ctr)
    runs = {}
    for name, kw in (("tight", {"slack": 1.0}), ("none", {})):
        scn = [mod.Scenario.cluster(
            CLUSTER, routing="slack_aware", max_slots=64,
            chains=mod.Chains(**kw), failures=outage(ctr))
            for mod in (ref, T)]
        r = ref.simulate(scn[0], ctr)
        runs[name] = p = T.simulate(scn[1], tr, device="cpu")
        np.testing.assert_array_equal(r.node, p.node)
        np.testing.assert_array_equal(r.outcome, p.outcome)
        np.testing.assert_array_equal(r.chains.missed, p.chains.missed)
    moved = runs["tight"].node != runs["none"].node
    assert moved.any()
    assert (runs["tight"].node[moved] == 1).all()        # the down node
    sticky = T.simulate(T.Scenario.cluster(
        CLUSTER, routing="sticky", max_slots=64, chains=T.Chains(),
        failures=outage(ctr)), tr, device="cpu")
    np.testing.assert_array_equal(sticky.node, runs["none"].node)


# ---------------------------------------------------------------------------
# deadline semantics on a hand-built trace (``tests/test_chains.py``'s)
# ---------------------------------------------------------------------------

def tiny_trace():
    """Three 2-stage chains on one 500 MB node: chain 0 completes, chain
    1's final stage (800 MB) can never fit and drops, chain 2's final
    stage is cut off by ``head(5)``."""
    f32, i32 = np.float32, np.int32
    return PortTrace(
        t=np.asarray([0.0, 1.0, 2.0, 3.0, 4.0, 5.0], f32),
        func_id=np.asarray([0, 1, 2, 3, 4, 5], i32),
        size_mb=np.asarray([100.0, 100.0, 100.0, 800.0, 100.0, 100.0], f32),
        cls=np.zeros(6, i32), warm_dur=np.full(6, 0.5, f32),
        cold_dur=np.full(6, 2.0, f32),
        chain_id=np.asarray([0, 1, 0, 1, 2, 2], i32),
        stage=np.asarray([0, 0, 1, 1, 0, 1], i32),
        chain_len=np.full(6, 2, i32))


def test_deadline_semantics():
    tr = tiny_trace()
    for chunk in (None, 1):
        cm = T.simulate(T.Scenario.kiss(500.0, chains=T.Chains()), tr,
                        chunk_events=chunk, device="cpu").chain_metrics()
        assert cm.n_chains == 3 and cm.done.all()
        assert cm.latency[0] == np.float32(4.0)       # two cold starts
        assert not cm.dropped[0] and not cm.missed[0]
        assert cm.dropped[1] and cm.missed[1]         # a drop misses
        tight = T.simulate(T.Scenario.kiss(500.0, chains=T.Chains(
            deadline_s=3.0)), tr, chunk_events=chunk,
            device="cpu").chain_metrics()
        assert tight.missed.all() and tight.deadline_miss_pct == 100.0
        cut = T.simulate(T.Scenario.kiss(500.0, chains=T.Chains()),
                         tr.head(5), chunk_events=chunk,
                         device="cpu").chain_metrics()
        assert not cut.done[2] and not cut.missed[2] and cut.n_done == 2
        assert cut.latency[2] > 0.0                   # observed stage
    slack = T.simulate(T.Scenario.kiss(500.0, chains=T.Chains(slack=3.0)),
                       tr, device="cpu").chain_metrics()
    np.testing.assert_array_equal(slack.deadline, np.float32(3.0))


def test_summary_keys_and_result_views(ctr):
    p = T.simulate(scenario(T, ctr, "sticky", "slack", "static"),
                   PortTrace(*ctr), device="cpu")
    cm, s = p.chain_metrics(), p.summary()
    assert s["n_chains"] == cm.n_chains
    assert s["deadline_miss_pct"] == cm.deadline_miss_pct \
        == p.deadline_miss_pct
    assert s["chain_p95_s"] == cm.chain_p95_s == p.chain_p95_s
    np.testing.assert_array_equal(p.chain_latency, cm.latency[cm.done])
    assert p.scenario.label.endswith("-chains")
    off = T.simulate(T.Scenario.cluster(CLUSTER, max_slots=64),
                     PortTrace(*ctr), device="cpu")
    assert off.chains is None and off.summary()["n_chains"] == 0
    with pytest.raises(ValueError, match="chains"):
        off.chain_metrics()


# ---------------------------------------------------------------------------
# the knob, the trace
# ---------------------------------------------------------------------------

def test_chains_require_chained_trace():
    from repro_torch.workloads import edge_trace
    tr = edge_trace(seed=0, duration_s=60)
    with pytest.raises(ValueError, match="chained trace"):
        T.simulate(T.Scenario.kiss(1024.0, chains=T.Chains()), tr,
                   device="cpu")
    from repro_torch.core import compile_chains
    with pytest.raises(ValueError, match="chained trace"):
        compile_chains(tr)


def test_chains_knob_validation():
    with pytest.raises(ValueError, match="not both"):
        T.Chains(deadline_s=1.0, slack=2.0)
    with pytest.raises(ValueError, match="positive"):
        T.Chains(deadline_s=-1.0)
    with pytest.raises(ValueError, match="positive"):
        T.Chains(slack=0.0)
    with pytest.raises(ValueError, match="positive number"):
        T.Chains(slack="tight")
    assert T.Scenario.kiss(1024.0, chains={"slack": 2.0}).chains \
        == T.Chains(slack=2.0)
    with pytest.raises(ValueError, match="chains must be"):
        T.Scenario.kiss(1024.0, chains=2.0)


def test_chain_plan_is_the_references(ref, ctr):
    """``compile_chains`` gives the reference's plan byte for byte (the
    slack deadlines' f32 sums included)."""
    from repro.core.continuum import compile_chains as ref_compile
    from repro_torch.core import compile_chains
    for kw in ({}, {"deadline_s": 6.0}, {"slack": 2.0}, {"slack": 1.3}):
        a, b = ref_compile(ctr, **kw), compile_chains(PortTrace(*ctr), **kw)
        assert a.n_chains == b.n_chains
        for f in ("cid", "stage", "last", "deadline"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_chained_trace_is_the_references(ref):
    """The port's generator draws the reference's trace on this numpy,
    and the stored benchmark trace is the reference's for the chain
    benchmark's config, pinned by its fingerprint."""
    from repro.workloads.chains import ChainConfig as RefConfig
    from repro.workloads.chains import chained_trace as ref_chained
    from test_torch_sim import _chip_smoke
    for kw in (dict(duration_s=200.0, seed=3),
               dict(duration_s=300.0, seed=1, chain_len=3, n_chains=7)):
        a, b = ref_chained(RefConfig(**kw)), chained_trace(ChainConfig(**kw))
        assert T.trace_fingerprint(b) == ref.trace_fingerprint(a)
    want = ref_chained(RefConfig(duration_s=1800.0, arrivals_rps=1.0,
                                 seed=0))
    stored = benchmark_chained_trace()
    for name, a, b in zip(want._fields, want, stored):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(stored) == 7076 and len(np.unique(stored.chain_id)) == 1769
    fp = _chip_smoke().GOLDEN_CHAINED_TRACE
    assert ref.trace_fingerprint(want) == T.trace_fingerprint(stored) == fp


def test_chain_goldens_are_the_references(ref):
    """``chip_smoke.py``'s chain phase holds the card to
    ``GOLDEN_CHAIN``: the reference's own results (``gather``) for the
    same scenarios on the stored benchmark trace."""
    from repro.core.types import Trace as RefTrace
    from test_torch_sim import _chip_smoke
    from test_torch_telemetry import to_ref
    smoke = _chip_smoke()
    trace = benchmark_chained_trace()
    scns = smoke.chain_scenarios()
    assert set(scns) == set(smoke.GOLDEN_CHAIN)
    for name, scn in scns.items():
        r = ref.simulate(to_ref(ref, scn), RefTrace(*trace))
        assert r.scenario.label == scn.label
        assert smoke.tel_digests(r) == smoke.GOLDEN_CHAIN[name], name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_chains_replay_matches_cpu(mode):
    """Chains with telemetry through the graphs (static and with the
    outage, monolithic and in chunks that split chains and blocks)
    equal the CPU's host loop bitwise under
    ``set_sync_debug_mode("error")``; a tight SLO under the outage moves
    ``slack_aware``'s routing on the card as on the CPU."""
    _card()
    tr = PortTrace(*chained_trace(ChainConfig(duration_s=60.0, seed=5)))
    k = graphs.BLOCK_EVENTS
    for regime, kind in (("slack", "static"), ("none", "failures"),
                         ("deadline", "failures")):
        scn = scenario(T, tr, "slack_aware", regime, kind)
        cpu = T.simulate(scn, tr, mode=mode, device="cpu")
        torch.cuda.set_sync_debug_mode("error")
        try:
            for chunk in (None, 2 * k + 3):
                got = T.simulate(scn, tr, mode=mode, chunk_events=chunk,
                                 device="cuda")
                assert_chains_equal(cpu, got, (mode, regime, kind, chunk))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    tight = dataclasses.replace(scn, chains=T.Chains(slack=1.0))
    a = T.simulate(tight, tr, mode=mode, device="cuda")
    assert_chains_equal(T.simulate(tight, tr, mode=mode, device="cpu"), a)
