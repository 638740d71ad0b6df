"""The port's numpy oracle against the reference's, on the CPU.

``repro_torch.core.cluster_outcomes_ref`` gives identical arrays, dtypes
included, to ``repro.core.cluster_outcomes_ref`` in every branch: static
KiSS and baseline nodes, het16 under every registered routing, failures,
autoscaling with and without node scaling (with a trailing partial
epoch), telemetry, chains with telemetry, and vertical scaling alone,
with failures and autoscaled.  Then the front door: ``simulate`` and
``sweep`` with ``engine="ref"`` give the reference's ``engine="ref"``
Results and the port's ``engine="torch", device="cpu"`` ones (every
per-event, per-epoch, window, per-chain and vertical array and every
``summary()`` key); the refusals still raise after validation; and the
oracle needs no card.  The reference is reached through fixtures, so the
file also collects where JAX is absent.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core.continuum as PC
import repro_torch.sim as T
from repro_torch.cluster import engine
from repro_torch.cluster.presets import het16_cluster
from repro_torch.core.types import Trace as PortTrace
from repro_torch.workloads import ChainConfig, chained_trace

ROUTINGS = ("sticky", "least_loaded", "size_aware", "power_of_two",
            "cost_model", "slack_aware")
N_EVENTS = 2500
HET16_EVENTS = 800
EPOCH = 256            # N_EVENTS % EPOCH != 0: a trailing partial epoch
WINDOW = 300


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def rc(ref):
    import repro.core.continuum
    return repro.core.continuum


@pytest.fixture(scope="module")
def qtrace(ref):
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(22), N_EVENTS)


@pytest.fixture(scope="module")
def ctrace():
    """A short chained trace (the port's generator; the reference's
    draws the same arrays, as ``tests/test_torch_chains.py`` pins)."""
    return chained_trace(ChainConfig(n_chains=12, duration_s=400.0,
                                     arrivals_rps=1.5, seed=4))


def same(a, b, what=""):
    """``a`` and ``b`` identical: arrays by dtype, shape and bytes,
    containers element by element."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, (what, i))
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (what, a.keys(),
                                                             b.keys())
        for k in a:
            same(a[k], b[k], (what, k))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (what, type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (what, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, (what, a, b)


def windows(t, n_nodes):
    """Two outage windows over the trace's span."""
    t = np.asarray(t)
    a, b, c = (float(t[int(len(t) * f)]) for f in (0.2, 0.45, 0.6))
    return ((a, b, 0), (b - 30.0, c, n_nodes - 1))


#: Each branch: (config kwargs, trace kind, a function that takes the
#: continuum module, the trace and ``n_nodes`` and returns the oracle's
#: keyword arguments).
BRANCHES = {
    "kiss": (dict(node_mb=(2048.0,), small_frac=(0.8,), unified=(False,),
                  max_slots=64), "q", lambda m, t, n: {}),
    "baseline": (dict(node_mb=(1024.0,), small_frac=(0.8,), unified=(True,),
                      policy="greedy_dual", max_slots=64), "q",
                 lambda m, t, n: {}),
    "failures": (dict(node_mb=(768.0, 1024.0, 2048.0),
                      small_frac=(0.8, 0.7, 0.6), unified=(False, True, False),
                      routing="least_loaded", max_slots=32), "q",
                 lambda m, t, n: dict(failures=m.Failures(windows(t.t, n)))),
    "autoscale": (dict(node_mb=(1024.0, 2048.0), small_frac=(0.8, 0.6),
                       unified=(False, False), routing="power_of_two",
                       policy="freq", max_slots=32), "q",
                  lambda m, t, n: dict(autoscale=m.Autoscale(
                      epoch_events=EPOCH, gain=0.3))),
    "autoscale_nodes_failures_telemetry": (
        dict(node_mb=(512.0, 1024.0, 1024.0, 2048.0), small_frac=(0.8,) * 4,
             unified=(False, True, False, False), routing="sticky",
             max_slots=32), "q",
        lambda m, t, n: dict(
            autoscale=m.Autoscale(epoch_events=EPOCH, spawn_drop_frac=0.02,
                                  retire_drop_frac=0.01, init_active=2),
            failures=m.Failures(windows(t.t, n)), telemetry=WINDOW)),
    "telemetry": (dict(node_mb=(1024.0, 1536.0), small_frac=(0.8, 0.7),
                       unified=(False, False), routing="cost_model",
                       max_slots=32), "q",
                  lambda m, t, n: dict(telemetry=WINDOW)),
    "chains_telemetry_failures": (
        dict(node_mb=(1024.0, 1024.0), small_frac=(0.8, 0.8),
             unified=(False, False), routing="slack_aware", max_slots=64),
        "c", lambda m, t, n: dict(
            chains=m.compile_chains(t, slack=3.0), telemetry=WINDOW,
            failures=m.Failures(windows(t.t, n)),
            chain_cold=m.cloud_cold_draws(len(t), 0.05))),
    "chains_autoscale": (
        dict(node_mb=(1024.0, 2048.0), small_frac=(0.8, 0.7),
             unified=(False, False), routing="size_aware", max_slots=64),
        "c", lambda m, t, n: dict(
            chains=m.compile_chains(t, deadline_s=20.0),
            autoscale=m.Autoscale(epoch_events=EPOCH),
            chain_cold=m.cloud_cold_draws(len(t), 0.05))),
    "resize": (dict(node_mb=(1024.0, 1024.0, 2048.0), small_frac=(0.8,) * 3,
                    unified=(False, True, False), routing="size_aware",
                    max_slots=32, resize_policy="fair_share",
                    resize_min_mb=16.0), "q", lambda m, t, n: {}),
    "resize_failures": (dict(node_mb=(1024.0, 2048.0), small_frac=(0.8, 0.7),
                             unified=(False, False), max_slots=32,
                             resize_policy="static"), "q",
                        lambda m, t, n: dict(
                            failures=m.Failures(windows(t.t, n)))),
    "resize_autoscale_telemetry": (
        dict(node_mb=(1024.0, 2048.0), small_frac=(0.8, 0.7),
             unified=(False, False), routing="least_loaded", max_slots=32,
             resize_policy="fair_share", resize_min_mb=32.0), "q",
        lambda m, t, n: dict(autoscale=m.Autoscale(
            epoch_events=EPOCH, spawn_drop_frac=0.05, retire_drop_frac=0.02),
            telemetry=WINDOW)),
}


def _both(rc, qtrace, ctrace, cfg_kw, kind, oracle_kw):
    """The reference's and the port's oracle outputs for one branch."""
    from repro.core.types import Trace as RefTrace
    rt = qtrace if kind == "q" else RefTrace(*ctrace)
    pt = PortTrace(*rt)
    n = len(cfg_kw["node_mb"])
    want = rc.cluster_outcomes_ref(rc.ClusterConfig(**cfg_kw), rt,
                                   **oracle_kw(rc, rt, n))
    got = PC.cluster_outcomes_ref(PC.ClusterConfig(**cfg_kw), pt,
                                  **oracle_kw(PC, pt, n))
    return want, got


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_oracle_matches_the_reference(branch, rc, qtrace, ctrace):
    want, got = _both(rc, qtrace, ctrace, *BRANCHES[branch])
    same(want, got, branch)
    assert got[1].dtype == np.int32
    outcomes = np.bincount(got[1], minlength=3)
    assert (outcomes > 0).all(), (branch, outcomes)   # hits, misses, drops


@pytest.mark.parametrize("routing", ROUTINGS)
def test_oracle_on_het16_matches_the_reference(routing, rc, qtrace):
    import repro.cluster.presets
    rt = qtrace.head(HET16_EVENTS)
    want = rc.cluster_outcomes_ref(
        repro.cluster.presets.het16_cluster(routing, max_slots=64), rt)
    got = PC.cluster_outcomes_ref(het16_cluster(routing, max_slots=64),
                                  PortTrace(*rt))
    same(want, got, routing)
    assert len(np.unique(got[0])) > 4


def test_oracle_autoscale_shapes(rc, qtrace, ctrace):
    """The autoscaled branch returns one row of ``fracs`` and ``active``
    an epoch, the trailing partial epoch included, and the retirements
    land in the window arrays."""
    _, (node, outcome, fracs, extras) = _both(
        rc, qtrace, ctrace, *BRANCHES["autoscale_nodes_failures_telemetry"])
    n_epochs = -(-N_EVENTS // EPOCH)
    assert fracs.shape == extras["active"].shape == (n_epochs, 4)
    assert fracs.dtype == np.float32 and extras["active"].dtype == bool
    tel = extras["telemetry"]
    assert tel["invalidated"].sum() == extras["invalidated"].sum() > 0
    assert extras["active"].sum(1).min() < extras["active"].sum(1).max()


# --------------------------------------------------------------------------
# the front door: simulate / sweep with engine="ref"
# --------------------------------------------------------------------------

def scenarios(mod, t):
    """Scenarios in package ``mod`` that reach every run shape."""
    fails = windows(t, 3)
    return {
        "kiss": mod.Scenario.kiss(2048.0, max_slots=64),
        "baseline": mod.Scenario.baseline(1536.0, replacement="freq",
                                          max_slots=64),
        "failures_telemetry": mod.Scenario.cluster(
            (768.0, 1024.0, 2048.0), routing="cost_model", max_slots=32,
            failures=fails, telemetry=WINDOW),
        "autoscale_nodes": mod.Scenario.cluster(
            (512.0, 1024.0, 2048.0), unified=(False, True, False),
            max_slots=32, failures=fails, telemetry=WINDOW,
            autoscale=mod.Autoscale(epoch_events=EPOCH, spawn_drop_frac=0.02,
                                    retire_drop_frac=0.01, init_active=2)),
        "resize": mod.Scenario.cluster(
            (1024.0, 1024.0, 2048.0), routing="size_aware", max_slots=32,
            resize=mod.Resize("fair_share", min_mb=16.0)),
        "resize_autoscale": mod.Scenario.cluster(
            (1024.0, 2048.0), routing="least_loaded", max_slots=32,
            resize=mod.Resize("fair_share", min_mb=32.0),
            autoscale=mod.Autoscale(epoch_events=EPOCH)),
    }


def chain_scenarios(mod, t):
    return {"chains": mod.Scenario.cluster(
        (1024.0, 1024.0), routing="slack_aware", max_slots=64,
        chains=mod.Chains(slack=3.0), failures=windows(t, 2),
        telemetry=WINDOW)}


def assert_same_result(r, p, what=""):
    """Per-event and per-epoch outputs, the failure arrays, the vertical
    totals, every window and per-chain array and every summary key,
    bitwise (``r`` either package's ``Result``, ``p`` the port's)."""
    for f in ("node", "outcome", "per_node", "fracs", "active",
              "invalidated", "node_up", "epoch_t"):
        x, y = getattr(r, f), getattr(p, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            same(np.asarray(x), np.asarray(y), (what, f))
    same(np.asarray(r.raw.latencies), np.asarray(p.raw.latencies),
         (what, "latencies"))
    assert (r.vertical is None) == (p.vertical is None), what
    for k in r.vertical or ():
        same(np.asarray(r.vertical[k]), p.vertical[k], (what, k))
    for owner in ("telemetry", "chains"):
        a, b = getattr(r, owner), getattr(p, owner)
        assert (a is None) == (b is None), (what, owner)
        for f in (dataclasses.fields(a) if a is not None else ()):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                same(x, y, (what, owner, f.name))
    assert r.summary() == p.summary(), what


@pytest.fixture(scope="module")
def head(qtrace):
    return qtrace.head(1200)


@pytest.mark.parametrize("name", ["kiss", "baseline", "failures_telemetry",
                                  "autoscale_nodes", "resize",
                                  "resize_autoscale"])
def test_simulate_ref_matches_both_engines(name, ref, head):
    pt = PortTrace(*head)
    r = ref.simulate(scenarios(ref, head.t)[name], head, engine="ref")
    scn = scenarios(T, pt.t)[name]
    p = T.simulate(scn, pt, engine="ref", device="cpu")
    assert_same_result(r, p, name)
    assert_same_result(T.simulate(scn, pt, device="cpu"), p, name)
    assert p.run_info == {**r.run_info, "device": "cpu"}


def test_simulate_ref_with_chains_matches_both_engines(ref, ctrace):
    from repro.core.types import Trace as RefTrace
    rt = RefTrace(*ctrace)
    r = ref.simulate(chain_scenarios(ref, rt.t)["chains"], rt, engine="ref")
    scn = chain_scenarios(T, ctrace.t)["chains"]
    p = T.simulate(scn, ctrace, engine="ref")
    assert p.chains is not None and p.telemetry is not None
    assert_same_result(r, p, "chains")
    assert_same_result(T.simulate(scn, ctrace, device="cpu"), p, "chains")


def test_sweep_ref_matches_both_engines(ref, head):
    """A mixed grid (static, failing, autoscaled, resize lanes), results
    in input order, each lane the reference's ``engine="ref"`` lane and
    the port's torch lane."""
    pt = PortTrace(*head)
    names = ["resize", "kiss", "autoscale_nodes", "failures_telemetry",
             "baseline"]
    rs, ps = scenarios(ref, head.t), scenarios(T, pt.t)
    want = ref.sweep(head, [rs[k] for k in names], engine="ref",
                     rng_seed=3, mode="fused")
    got = T.sweep(pt, [ps[k] for k in names], engine="ref", rng_seed=3,
                  mode="fused", device="cpu")
    torch_lanes = T.sweep(pt, [ps[k] for k in names], rng_seed=3,
                          device="cpu")
    for k, r, p, q in zip(names, want, got, torch_lanes):
        assert p.scenario == ps[k]
        assert_same_result(r, p, k)
        assert_same_result(q, p, k)
        assert p.run_info["engine"] == "ref" and p.run_info["rng_seed"] == 3


def test_ref_ignores_chunking_and_mode(head):
    pt = PortTrace(*head)
    scn = scenarios(T, pt.t)["failures_telemetry"]
    want = T.simulate(scn, pt, engine="ref")
    for kw in (dict(chunk_events=97), dict(mode="fused"),
               dict(device="cuda")):
        assert_same_result(want, T.simulate(scn, pt, engine="ref", **kw),
                           kw)


def test_ref_refusals_after_validation(head):
    pt = PortTrace(*head).head(50)
    scn = T.Scenario.kiss(1024.0, max_slots=16)
    asc = T.Scenario.kiss(1024.0, autoscale=T.Autoscale(epoch_events=16))
    with pytest.raises(ValueError, match="mode must be one of"):
        T.simulate(scn, pt, engine="ref", mode="scatter")
    with pytest.raises(ValueError, match="mode must be one of"):
        T.sweep(pt, [scn], engine="ref", mode="scatter")
    with pytest.raises(ValueError, match="chunk_events does not compose"):
        T.simulate(asc, pt, engine="ref", chunk_events=10)
    with pytest.raises(ValueError, match="chunk_events does not compose"):
        T.sweep(pt, [scn, asc], engine="ref", chunk_events=10)
    with pytest.raises(ValueError, match="non-empty"):
        T.sweep(pt, [], engine="ref")
    with pytest.raises(ValueError, match="exceeds"):
        T.sweep(pt, [scn], engine="ref",
                devices=engine._device_count() + 1)
    with pytest.raises(ValueError, match="engine must be one of"):
        T.simulate(scn, pt, engine="jax")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        T.simulate(scn, pt, engine="ref", device="meta")


def test_ref_needs_no_card(monkeypatch, head):
    """``engine="ref"`` runs with no ``device`` where CUDA is absent;
    the torch engine still refuses to fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt = PortTrace(*head).head(300)
    scn = T.Scenario.kiss(1024.0, max_slots=16)
    p = T.simulate(scn, pt, engine="ref")
    (q,) = T.sweep(pt, [scn], engine="ref")
    assert_same_result(p, q)
    assert p.run_info["device"] == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.simulate(scn, pt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.sweep(pt, [scn])
