"""Failure injection in the PyTorch port against the reference
``repro.sim``: ``Failures.masks``, the routing x step-mode grid (node,
outcome, ``invalidated``, ``node_up`` and every summary key, bitwise),
the semantics (a down node is frozen and routed around, all nodes down
go to the cloud, recovery re-warms, a window between two events still
clears, overlapping windows clear once) and the validation errors.  The
reference (and ``conftest``, which imports it) is reached through
fixtures."""
import numpy as np
import pytest

import repro_torch.sim as T
from repro_torch.core.types import DROP, HIT, MISS
from repro_torch.core.types import Trace as PortTrace

BUILTIN_ROUTINGS = ["sticky", "least_loaded", "size_aware", "power_of_two",
                    "cost_model"]


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def qtrace():
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(0), 450)


def mid_windows(tr, frac_lo=0.25, frac_hi=0.6, nodes=(0, 2)):
    """Outage windows over the middle of the trace (the reference's
    ``tests/test_failures.py`` helper), as window tuples."""
    t0 = float(tr.t[int(len(tr) * frac_lo)])
    t1 = float(tr.t[int(len(tr) * frac_hi)])
    return tuple((t0 + 3 * i, t1 + 11 * i, n) for i, n in enumerate(nodes))


def het4(mod, routing="sticky", failures=None):
    return mod.Scenario.cluster((1024.0, 1024.0, 2048.0, 4096.0),
                                small_frac=(0.8, 0.8, 0.8, 0.5),
                                unified=(False, True, False, False),
                                routing=routing, max_slots=64,
                                failures=failures)


def uniform_trace(n, n_funcs=6, size=64.0, gap=1.0, warm=0.5, cold=3.0):
    """Deterministic round-robin trace on exact-f32 values."""
    i = np.arange(n)
    return dict(t=(i * gap).astype(np.float32),
                func_id=(i % n_funcs).astype(np.int32),
                size_mb=np.full(n, size, np.float32),
                cls=np.zeros(n, np.int32),
                warm_dur=np.full(n, warm, np.float32),
                cold_dur=np.full(n, cold, np.float32))


def assert_bitwise(r, p, what=""):
    assert np.array_equal(np.asarray(r.node), p.node), what
    assert np.array_equal(np.asarray(r.outcome), p.outcome), what
    assert np.array_equal(r.per_node, p.per_node), what
    assert np.array_equal(r.invalidated, p.invalidated), what
    assert p.invalidated.dtype == np.int64
    assert np.array_equal(r.node_up, p.node_up), what
    assert r.summary() == p.summary(), what


def test_masks_match_reference(ref, qtrace):
    """The compiled up/recover masks are the reference's arrays, for
    windows inside the trace, between two events, overlapping, and
    reaching past its end."""
    t = np.asarray(qtrace.t)
    schedules = [mid_windows(qtrace),
                 ((float(t[10]) + 1e-3, float(t[10]) + 2e-3, 1),),
                 ((100.0, 900.0, 3), (500.0, 1500.0, 3), (0.0, 50.0, 0)),
                 ((3000.0, 1e9, 2),)]
    for windows in schedules:
        want = ref.Failures(windows=windows).masks(t, 4)
        got = T.Failures(windows=windows).masks(t, 4)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype == bool and np.array_equal(a, b)
    f = T.Failures(((1.0, 2.0, 5),))
    assert f.max_node == 5
    with pytest.raises(ValueError, match="out of range"):
        f.masks(t, 4)


@pytest.fixture(scope="module")
def ref_grid(ref, qtrace):
    """The reference's ``gather`` run for each routing (its modes are
    bitwise equal to one another, by its own tests)."""
    cache = {}

    def run(routing):
        if routing not in cache:
            cache[routing] = ref.simulate(
                het4(ref, routing, mid_windows(qtrace)), qtrace)
        return cache[routing]
    return run


@pytest.mark.parametrize("mode", ["gather", "vmap", "fused"])
@pytest.mark.parametrize("routing", BUILTIN_ROUTINGS)
def test_failures_match_reference(routing, mode, ref_grid, qtrace):
    r = ref_grid(routing)
    p = T.simulate(het4(T, routing, mid_windows(qtrace)),
                   PortTrace(*qtrace), mode=mode, device="cpu")
    assert_bitwise(r, p, (routing, mode))
    assert p.n_invalidated > 0 and p.summary()["downtime_pct"] > 0.0


def test_down_node_is_frozen_and_invisible(ref, qtrace):
    """Mask-aware routing sends nothing to a down node, and a schedule
    that touches no event leaves the run identical to the static one."""
    tr = PortTrace(*qtrace)
    fails = mid_windows(qtrace, nodes=(0,))
    res = T.simulate(het4(T, "least_loaded", fails), tr, device="cpu")
    assert_bitwise(ref.simulate(het4(ref, "least_loaded", fails), qtrace),
                   res)
    down = ~res.node_up[:, 0]
    assert down.any()
    assert (res.node[down] != 0).all()
    static = T.simulate(het4(T, "least_loaded"), tr, device="cpu")
    harmless = T.simulate(het4(T, "least_loaded", ((-10.0, -1.0, 0),)), tr,
                          device="cpu")
    assert (harmless.outcome == static.outcome).all()
    assert harmless.n_invalidated == 0
    assert harmless.summary()["downtime_pct"] == 0.0
    assert static.node_up is None and static.invalidated is None
    assert static.summary()["n_invalidated"] == 0


def test_all_nodes_down_falls_to_cloud(ref):
    arrays = uniform_trace(60)
    fails = ((20.0, 40.0, 0),)
    res = T.simulate(T.Scenario.kiss(1024.0, max_slots=32, failures=fails),
                     PortTrace(**arrays), device="cpu")
    from repro.core.types import Trace as RefTrace
    assert_bitwise(ref.simulate(ref.Scenario.kiss(
        1024.0, max_slots=32, failures=fails), RefTrace(**arrays)), res)
    t = arrays["t"]
    win = (t >= 20.0) & (t < 40.0)
    assert win.any()
    assert (res.outcome[win] == DROP).all()
    assert (res.latencies[win] >= 0.25).all()


def test_recovery_invalidates_residents_and_rewarms():
    """Functions warm before the outage cold-start again after it."""
    arrays = uniform_trace(60, n_funcs=6)
    tr, t = PortTrace(**arrays), arrays["t"]
    res = T.simulate(T.Scenario.kiss(1024.0, max_slots=32,
                                     failures=((20.0, 40.0, 0),)), tr,
                     device="cpu")
    assert res.invalidated.tolist() == [6]
    assert res.n_invalidated == 6
    first = int(np.argmax(t >= 40.0))
    assert (res.outcome[first:first + 6] == MISS).all()
    no_fail = T.simulate(T.Scenario.kiss(1024.0, max_slots=32), tr,
                         device="cpu")
    assert (no_fail.outcome[first:first + 6] == HIT).all()
    s, s0 = res.summary(), no_fail.summary()
    assert s["cold_start_pct"] > s0["cold_start_pct"]
    assert s["downtime_pct"] > 0.0 and s["n_invalidated"] == 6
    assert res.node_downtime_pct[0] == pytest.approx(
        100.0 * ((t >= 20.0) & (t < 40.0)).mean())


def test_window_between_events_still_invalidates():
    arrays = uniform_trace(10, n_funcs=2, gap=10.0)
    fails = T.Failures(windows=((41.0, 44.0, 0),))
    up, recover = fails.masks(arrays["t"], 1)
    assert up.all()
    assert recover[5, 0] and recover.sum() == 1
    res = T.simulate(T.Scenario.kiss(1024.0, max_slots=8, failures=fails),
                     PortTrace(**arrays), device="cpu")
    assert res.invalidated.tolist() == [2]
    assert (res.outcome[5:7] == MISS).all()


def test_overlapping_windows_fire_one_recovery():
    arrays = uniform_trace(40, n_funcs=2)
    tr = PortTrace(**arrays)
    fails = T.Failures(windows=((10.0, 20.0, 0), (15.0, 30.0, 0)))
    up, recover = fails.masks(arrays["t"], 1)
    assert (~up[:, 0]).sum() == 20
    assert recover.sum() == 1
    res = T.simulate(T.Scenario.kiss(1024.0, max_slots=8, failures=fails),
                     tr, device="cpu")
    assert res.n_invalidated > 0
    merged = T.simulate(T.Scenario.kiss(
        1024.0, max_slots=8, failures=((10.0, 30.0, 0),)), tr, device="cpu")
    assert (res.outcome == merged.outcome).all()
    assert res.n_invalidated == merged.n_invalidated


def test_failures_validation(ref):
    with pytest.raises(ValueError, match="t_down < t_up"):
        T.Failures(windows=((5.0, 5.0, 0),))
    with pytest.raises(ValueError, match="at least one"):
        T.Failures(windows=())
    with pytest.raises(ValueError, match="t_down, t_up, node"):
        T.Failures(windows=((1.0, 2.0),))
    with pytest.raises(ValueError, match=">= 0"):
        T.Failures(windows=((1.0, 2.0, -1),))
    with pytest.raises(ValueError, match="references node"):
        T.Scenario.kiss(1024.0, failures=T.Failures(windows=((1.0, 2.0, 3),)))
    with pytest.raises(ValueError, match="failures"):
        T.Scenario.kiss(1024.0, failures=object())
    sc = T.Scenario.cluster((1024.0, 2048.0), failures=((1.0, 2.0, 1),))
    assert sc.failures == T.Failures(windows=((1.0, 2.0, 1),))
    assert hash(sc) != hash(T.Scenario.cluster((1024.0, 2048.0)))
    assert sc.label.endswith("-failures")
    assert sc.label == ref.Scenario.cluster(
        (1024.0, 2048.0), failures=((1.0, 2.0, 1),)).label


def test_failure_goldens_are_the_references(ref):
    """``chip_smoke.py``'s failure phase holds the card to
    ``GOLDEN_FAIL``: the reference's own results for the same scenario
    (``chip_smoke.failure_scenario``) on the stored trace's head."""
    import dataclasses
    from repro.cluster.presets import het16_cluster
    from repro.core.types import Trace as RefTrace
    from repro_torch.workloads import quickstart_trace
    from test_torch_sim import _chip_smoke, _digests
    smoke = _chip_smoke()
    head = quickstart_trace().head(smoke.SIM_EVENTS)
    port_scn = smoke.failure_scenario(head)
    scn = dataclasses.replace(
        ref.Scenario.from_cluster(het16_cluster("size_aware")),
        failures=ref.Failures(port_scn.failures.windows))
    assert scn.label == port_scn.label
    r = ref.simulate(scn, RefTrace(*head))
    g = smoke.GOLDEN_FAIL
    assert _digests(r) == {k: g[k] for k in ("node", "outcome", "counts")}
    assert r.invalidated.tolist() == g["invalidated"]
    assert r.summary()["downtime_pct"] == g["downtime_pct"]
