"""Sweeps (``repro_torch.sim.sweep``) in the PyTorch port against the
reference ``repro.sim.sweep`` and the port's own ``simulate``, bitwise.

On the CPU, on a short quantized trace and 3-node clusters of 32 slots a
pool whose lanes differ in every per-lane knob (capacities, splits,
unified nodes, routing and replacement policies, cloud pricing, failure
windows, telemetry windows share a group): the static, failure-injected
and telemetry groups in every step mode, monolithic and chunked, and a
per-scenario mode list; each lane equal to the reference's sweep lane
and to ``simulate`` of its scenario (node, outcome, every ``summary()``
key, the window arrays, ``node_up`` and ``invalidated``).  Also a sweep
that mixes groups (results in input order), the engine's sweep entry
points with the reference's return shapes, the run info and manifest,
the refusals (``_stack_configs``, ``check_devices``, a ``devices``
count above the run's devices, no device without CUDA), ``engine="ref"`` after the same validation, and
the JAX side of ``chip_smoke.GOLDEN_SWEEP`` on a sub-grid.  Autoscaled,
chain and resize groups, the block runner with lanes and the lane
spelling of the routing bodies are in
``tests/test_torch_sweep_shapes.py``.  The reference (and
``conftest``) is reached through fixtures, so the file also collects
where JAX is absent.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.sim as T
from repro_torch.cluster import engine
from repro_torch.core.types import Trace as PortTrace

MODES = ("gather", "vmap", "fused")
N_EVENTS = 320
CHUNK = 101
NODES = 3
WINDOW = 64


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def qtrace():
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(21), N_EVENTS)


def static_lanes(mod, **kw):
    """Six lanes of one 3-node group (32 slots a pool), differing in
    every static per-lane knob, in package ``mod``."""
    c = mod.Scenario.cluster
    return [
        c((768.0, 1024.0, 2048.0), routing="size_aware", max_slots=32,
          name="size_aware", **kw),
        c((1024.0, 1024.0, 1024.0), small_frac=(0.9, 0.7, 0.5),
          routing="least_loaded", replacement="greedy_dual", max_slots=32,
          name="least_loaded", **kw),
        c((512.0, 2048.0, 1024.0), unified=(True, False, False),
          routing="cost_model", cloud_rtt_s=0.5, cloud_cold_prob=0.3,
          max_slots=32, name="cost_model", **kw),
        c((2048.0, 512.0, 768.0), routing="power_of_two",
          replacement="freq", max_slots=32, name="power_of_two", **kw),
        c((1024.0, 768.0, 1536.0), routing="sticky", max_slots=32,
          cloud_cold_prob=0.9, name="sticky", **kw),
        c((1024.0, 768.0, 1536.0), routing="slack_aware", max_slots=32,
          unified=True, name="slack_aware", **kw)]


def windows(tr, lane):
    """A lane's outage windows over the trace: each lane its own."""
    t = np.asarray(tr.t)
    a = float(t[int(len(t) * (0.1 + 0.1 * (lane % 4)))])
    b = float(t[int(len(t) * (0.45 + 0.08 * (lane % 3)))])
    return ((a, b, lane % NODES), (a + 5.0, b + 40.0, (lane + 1) % NODES))


def failure_lanes(mod, tr, **kw):
    return [dataclasses.replace(s, failures=mod.Failures(windows(tr, i)))
            for i, s in enumerate(static_lanes(mod, **kw))]


def assert_bitwise(r, p, what=""):
    """Per-event and per-epoch outputs, the failure arrays, the vertical
    totals, every window and per-chain array and every summary key,
    bitwise (``r`` either package's ``Result``, ``p`` the port's)."""
    for f in ("node", "outcome", "per_node", "fracs", "active",
              "invalidated", "node_up", "epoch_t"):
        x, y = getattr(r, f), getattr(p, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            x = np.asarray(x)
            assert x.dtype == y.dtype, (what, f, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
    assert (r.vertical is None) == (p.vertical is None), what
    for k in r.vertical or ():
        x, y = np.asarray(r.vertical[k]), p.vertical[k]
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (what, k)
    for owner in ("telemetry", "chains"):
        a, b = getattr(r, owner), getattr(p, owner)
        assert (a is None) == (b is None), (what, owner)
        for f in (dataclasses.fields(a) if a is not None else ()):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                    (what, owner, f.name)
    assert r.summary() == p.summary(), what


def check_lanes(want, got, what):
    """Every lane of ``got`` equals ``want``'s, and has the port's run
    info."""
    assert len(want) == len(got), what
    for i, (r, p) in enumerate(zip(want, got)):
        assert_bitwise(r, p, (what, i))
        assert p.run_info["engine"] == "torch"


@pytest.fixture(scope="module")
def ref_static(ref, qtrace):
    """The reference's sweeps of the static, failure and telemetry
    groups (``gather``: its modes are bitwise equal, by its tests)."""
    from repro.core.types import Trace as RefTrace
    tr = RefTrace(*qtrace)
    return {"static": ref.sweep(tr, static_lanes(ref)),
            "failures": ref.sweep(tr, failure_lanes(ref, qtrace)),
            "telemetry": ref.sweep(tr, failure_lanes(ref, qtrace,
                                                     telemetry=WINDOW))}


def port_lanes(kind, tr):
    if kind == "static":
        return static_lanes(T)
    if kind == "failures":
        return failure_lanes(T, tr)
    return failure_lanes(T, tr, telemetry=WINDOW)


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["mono", "chunked"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["static", "failures", "telemetry"])
def test_sweep_matches_reference(kind, mode, chunk, ref_static, qtrace):
    """Each lane of a group equals the reference's sweep lane, in every
    mode, monolithic and chunked (on the CPU a chunked run goes through
    the block runner, eagerly)."""
    got = T.sweep(PortTrace(*qtrace), port_lanes(kind, qtrace), mode=mode,
                  chunk_events=chunk, device="cpu")
    check_lanes(ref_static[kind], got, (kind, mode, chunk))
    assert {r.run_info["mode"] for r in got} == {mode}


@pytest.mark.parametrize("kind,mode", [("static", "fused"),
                                       ("failures", "vmap"),
                                       ("telemetry", "gather")])
def test_each_lane_is_its_simulate(kind, mode, qtrace):
    """A sweep lane is bitwise the port's ``simulate`` of its scenario
    (the one-lane case of the same step), over the trace's first 200
    events."""
    tr = PortTrace(*qtrace).head(200)
    scns = port_lanes(kind, qtrace)
    got = T.sweep(tr, scns, mode=mode, device="cpu")
    check_lanes([T.simulate(s, tr, mode=mode, device="cpu") for s in scns],
                got, (kind, mode))


def test_per_scenario_modes_and_mixed_groups(ref, ref_static, qtrace):
    """A sweep that mixes groups (node counts, slots, failures on and
    off, telemetry windows, autoscaled lanes, resize, per-scenario modes)
    runs one group each and returns the results in input order, each the
    reference's lane (lanes are independent in the reference)."""
    from repro.core.types import Trace as RefTrace

    def extra(mod):
        return [mod.Scenario.kiss(2048.0, max_slots=16),
                mod.Scenario.kiss(3072.0, max_slots=16,
                                  autoscale=mod.Autoscale(epoch_events=128,
                                                          gain=0.2)),
                dataclasses.replace(static_lanes(mod)[1], resize="static"),
                mod.Scenario.baseline(2048.0, max_slots=16)]
    st, fl = static_lanes(T), failure_lanes(T, qtrace)
    tl = failure_lanes(T, qtrace, telemetry=WINDOW)
    ex = extra(T)
    grid = [st[0], fl[1], ex[0], st[2], tl[3], ex[1], fl[4], ex[2], ex[3],
            st[5]]
    rs, rx = ref_static, ref.sweep(RefTrace(*qtrace), extra(ref))
    want = [rs["static"][0], rs["failures"][1], rx[0], rs["static"][2],
            rs["telemetry"][3], rx[1], rs["failures"][4], rx[2], rx[3],
            rs["static"][5]]
    modes = ["fused", "gather", "vmap", "gather", "fused", "vmap", "gather",
             "fused", "vmap", "vmap"]
    got = T.sweep(PortTrace(*qtrace), grid, mode=modes, device="cpu")
    check_lanes(want, got, "mixed")
    assert [r.run_info["mode"] for r in got] == modes
    assert [r.scenario for r in got] == grid


def test_engine_entry_points_have_the_reference_shapes(ref, qtrace):
    """``_sweep_cluster``, ``_sweep_cluster_failures`` and
    ``_sweep_cluster_chunked`` return the reference's shapes (plain
    results, or ``(result, extras)`` pairs with failures, telemetry,
    chains or resize) with its node and outcome arrays."""
    from repro.cluster import engine as RE
    from repro.core.types import Trace as RefTrace
    rtr, ptr = RefTrace(*qtrace), PortTrace(*qtrace)
    rc = [s.to_cluster_config() for s in static_lanes(ref)[:3]]
    pc = [s.to_cluster_config() for s in static_lanes(T)[:3]]
    fails = [T.Failures(windows(qtrace, i)) for i in range(3)]
    rfails = [ref.Failures(f.windows) for f in fails]
    cases = [
        (RE._sweep_cluster(rtr, rc, mode="gather"),
         engine._sweep_cluster(ptr, pc, mode="vmap", device="cpu")),
        (RE._sweep_cluster_failures(rtr, rc, rfails),
         engine._sweep_cluster_failures(ptr, pc, fails, mode="fused",
                                        device="cpu")),
        (RE._sweep_cluster_chunked(rtr, rc, chunk_events=CHUNK,
                                   failures=[rfails[0], None, rfails[2]]),
         engine._sweep_cluster_chunked(ptr, pc, chunk_events=CHUNK,
                                       failures=[fails[0], None, fails[2]],
                                       device="cpu"))]
    for k, (want, got) in enumerate(cases):
        assert len(want) == len(got) == 3
        for w, g in zip(want, got):
            assert isinstance(w, tuple) == isinstance(g, tuple), k
            if isinstance(w, tuple):
                (w, wx), (g, gx) = w, g
                assert set(wx) == set(gx), k
                np.testing.assert_array_equal(wx["invalidated"],
                                              gx["invalidated"])
                np.testing.assert_array_equal(wx["node_up"], gx["node_up"])
            np.testing.assert_array_equal(w.node, g.node)
            np.testing.assert_array_equal(w.outcome, g.outcome)
            np.testing.assert_array_equal(w.latencies, g.latencies)


def test_run_info_and_manifest_equal_the_references(ref, qtrace):
    """A lane's run info holds the reference's keys plus the port's
    ``device``, and its manifest is the reference's but for the engine,
    the device and the versions."""
    from repro.core.types import Trace as RefTrace
    want = ref.sweep(RefTrace(*qtrace), failure_lanes(ref, qtrace)[:2],
                     chunk_events=CHUNK, devices=1)
    got = T.sweep(PortTrace(*qtrace), failure_lanes(T, qtrace)[:2],
                  chunk_events=CHUNK, devices=1, device="cpu")
    for w, g in zip(want, got):
        info = dict(g.run_info)
        assert info.pop("engine") == "torch" and info.pop("device") == "cpu"
        assert info == {k: v for k, v in w.run_info.items() if k != "engine"}
        wm, gm = w.manifest(), g.manifest()
        assert set(wm) == set(gm)
        for key in set(gm) - {"versions", "run"}:
            assert gm[key] == wm[key], key
        run = dict(gm["run"])
        run.pop("device")
        assert run.pop("engine") == "torch"
        assert run == {k: v for k, v in wm["run"].items() if k != "engine"}
        assert T.run_manifest(g) == gm


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_stack_configs_refusals():
    a = static_lanes(T)[0].to_cluster_config()
    two = T.Scenario.cluster((1024.0, 1024.0), max_slots=32)
    slots = dataclasses.replace(static_lanes(T)[1], max_slots=16)
    rz = dataclasses.replace(static_lanes(T)[1], resize="static")
    for other in (two, slots):
        with pytest.raises(ValueError, match="share n_nodes and max_slots"):
            engine._stack_configs([a, other.to_cluster_config()], "test")
    with pytest.raises(ValueError, match="vertical scaling on/off"):
        engine._stack_configs([a, rz.to_cluster_config()], "test")
    with pytest.raises(ValueError, match="non-empty"):
        engine._stack_configs([], "test")
    tr = PortTrace(*engine_trace())
    with pytest.raises(ValueError, match="share n_nodes"):
        engine._sweep_cluster(tr, [a, two.to_cluster_config()],
                              device="cpu")
    with pytest.raises(ValueError, match="one Failures"):
        engine._sweep_cluster_failures(tr, [a], [None, None], device="cpu")


def engine_trace():
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(5), 20)


@pytest.mark.parametrize("bad", ["two", "", 0, -1, 1.5, True, None])
def test_check_devices_errors(bad):
    if bad is None:
        assert engine.check_devices(None) is None
        assert engine.check_devices(1) == 1
        if torch.cuda.device_count() <= 1:
            assert engine.check_devices("all") == 1
        return
    with pytest.raises(ValueError, match="positive int, 'all' or None"):
        engine.check_devices(bad)


def test_sweep_refusals(qtrace):
    tr = PortTrace(*qtrace).head(50)
    scn = static_lanes(T)[0]
    with pytest.raises(ValueError, match="non-empty"):
        T.sweep(tr, [], device="cpu")
    with pytest.raises(ValueError, match="engine must be one of"):
        T.sweep(tr, [scn], engine="jax", device="cpu")
    with pytest.raises(ValueError, match="per-scenario mode needs 1"):
        T.sweep(tr, [scn], mode=["gather", "fused"], device="cpu")
    with pytest.raises(ValueError, match="mode must be one of"):
        T.sweep(tr, [scn], mode="scatter", device="cpu")
    asc = T.Scenario.kiss(2048.0, autoscale=T.Autoscale(epoch_events=16))
    with pytest.raises(ValueError, match="chunk_events does not compose"):
        T.sweep(tr, [scn, asc], chunk_events=10, device="cpu")
    with pytest.raises(ValueError, match="positive int"):
        T.sweep(tr, [scn], devices=0, device="cpu")
    # A14: the oracle validates as the torch engine does, then runs
    with pytest.raises(ValueError, match="non-empty"):
        T.sweep(tr, [], engine="ref", device="cpu")
    with pytest.raises(ValueError, match="mode must be one of"):
        T.sweep(tr, [scn], engine="ref", mode="scatter")
    with pytest.raises(ValueError, match="exceeds"):
        T.sweep(tr, [scn], engine="ref", devices=engine._device_count() + 1)
    got = T.sweep(tr, [scn, scn], engine="ref", device="cpu")
    want = T.simulate(scn, tr, device="cpu")
    for p in got + [T.simulate(scn, tr, engine="ref")]:
        assert_bitwise(want, p, "ref")
        assert p.run_info["engine"] == "ref"
    # sharded sweeps: a CPU run has one device
    with pytest.raises(ValueError, match="exceeds"):
        T.sweep(tr, [scn], devices=2, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        engine.check_devices(engine._device_count() + 1)


def test_sweep_without_a_device_needs_cuda(qtrace):
    """``device=None`` means the card: without one, ``sweep`` raises
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.sweep(PortTrace(*qtrace).head(10), static_lanes(T)[:2])


# ---------------------------------------------------------------------------
# the goldens of chip_smoke.py's sweep phase
# ---------------------------------------------------------------------------

#: The sub-grid whose ``GOLDEN_SWEEP`` entries this file recomputes with
#: the reference: a static and an autoscaled lane of the edge grid, a
#: routing lane over the path head and two chain lanes.
GOLDEN_SUBGRID = {"edge_grid": ("kiss_4g_0.8", "adaptive_3g"),
                  "routing_grid_head": ("cost_model",),
                  "chain_grid": ("slack_aware-loose", "sticky-none")}


def test_sweep_goldens_are_the_references(ref):
    """``chip_smoke.py``'s sweep phase holds every lane to
    ``GOLDEN_SWEEP``; on a sub-grid (lanes are independent in the
    reference) the entries are the reference's own sweep results
    (``gather``) on the stored traces, and the grids are the repo's own
    (``examples/kiss_edge_sim.py``, ``routing_comparison``,
    ``chain_grid``) with a golden for every lane."""
    from repro.core.types import Trace as RefTrace
    from repro_torch.workloads import (benchmark_chained_trace,
                                       quickstart_trace)
    from test_torch_sim import _chip_smoke
    from test_torch_telemetry import to_ref
    smoke = _chip_smoke()
    grids = {"edge_grid": smoke.edge_grid(),
             "routing_grid": smoke.routing_grid(),
             "routing_grid_head": smoke.routing_grid(),
             "chain_grid": smoke.chain_grid()}
    assert len(grids["edge_grid"]) == 48 and len(grids["chain_grid"]) == 18
    assert set(smoke.GOLDEN_SWEEP) == set(grids)
    for g, lanes in grids.items():
        assert set(smoke.GOLDEN_SWEEP[g]) == set(lanes), g
    full, head = quickstart_trace(), quickstart_trace().head(
        smoke.SIM_EVENTS)
    traces = {"edge_grid": full, "routing_grid_head": head,
              "chain_grid": benchmark_chained_trace()}
    for g, names in GOLDEN_SUBGRID.items():
        scns = [grids[g][k] for k in names]
        got = ref.sweep(RefTrace(*traces[g]), [to_ref(ref, s) for s in scns])
        for k, r in zip(names, got):
            assert smoke.sweep_golden(r) == tuple(smoke.GOLDEN_SWEEP[g][k]), \
                (g, k)
