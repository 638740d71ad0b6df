"""The PyTorch port's ``simulate`` against the reference ``repro.sim``.

Bitwise per-event ``node``/``outcome`` and every ``summary()`` key on a
quantized trace, across routing x replacement x step mode; the no-JAX
rules of the port; the knobs this slice refuses; and the golden digests
that ``chip_smoke.py`` holds the card's full-size runs to.  The
reference (and ``conftest``, which imports it) is reached through
fixtures, so the file also collects where JAX is absent (the GPU host),
for the ``cuda`` tests.
"""
import ast
import hashlib
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.sim as T
from repro_torch._device import resolve_device
from repro_torch.cluster.engine import STEP_MODES
from repro_torch.core.pool import init_pool
from repro_torch.core.types import DROP, MISS, Policy, PoolConfig
from repro_torch.core.types import Trace as PortTrace
from repro_torch.kernels.pool_step import evict_place_cuda
from repro_torch.sim.scenario import NOT_PORTED
from repro_torch.workloads import edge_trace, quickstart_trace

ROOT = Path(__file__).resolve().parents[1]
ROUTINGS = ("sticky", "least_loaded", "size_aware", "power_of_two",
            "cost_model", "slack_aware")
REPLACEMENTS = ("lru", "greedy_dual", "freq")
MATRIX = ([("gather", r, p) for r in ROUTINGS for p in REPLACEMENTS]
          + [(m, r, "lru") for m in ("vmap", "fused") for r in ROUTINGS]
          + [(m, "size_aware", p) for m in ("vmap", "fused")
             for p in ("greedy_dual", "freq")])
#: Where the reference runs in the port's own mode (``vmap``, and
#: ``fused`` in interpret mode) rather than its ``gather``.
REF_OWN_MODE = (("size_aware", "lru"),)


def scenario(mod, routing="sticky", replacement="lru"):
    """Two nodes — a KiSS 512 MB node (its 102 MB large pool can host no
    large container) and a unified 1 GB node — with 16 slots a pool, so
    misses evict and some requests drop."""
    return mod.Scenario.cluster((512.0, 1024.0), small_frac=(0.8, 0.5),
                                unified=(False, True), routing=routing,
                                replacement=replacement, max_slots=16)


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def qtrace():
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(0), 400)


def assert_bitwise(r, p, what):
    assert np.array_equal(np.asarray(r.node), p.node), what
    assert np.array_equal(np.asarray(r.outcome), p.outcome), what
    assert r.summary() == p.summary(), what


@pytest.fixture(scope="module")
def ref_runs(ref, qtrace):
    """The reference's result for ``(mode, routing, replacement)``, each
    run once.  Its modes are bitwise equal to one another (its own
    ``tests/test_pool_kernel.py``), so beyond :data:`REF_OWN_MODE` the
    port's ``vmap``/``fused`` runs are held to the reference's
    ``gather`` run, which spares the slow interpret-mode ``fused``."""
    cache = {}

    def run(mode, routing, replacement):
        if (routing, replacement) not in REF_OWN_MODE:
            mode = "gather"
        key = mode, routing, replacement
        if key not in cache:
            cache[key] = ref.simulate(scenario(ref, routing, replacement),
                                      qtrace, mode=mode)
        return cache[key]
    return run


@pytest.mark.parametrize("mode,routing,replacement", MATRIX)
def test_port_matches_reference(mode, routing, replacement, ref_runs,
                                qtrace):
    """Per event and every summary key, bitwise: the port on the CPU vs
    the reference (in the same mode for :data:`REF_OWN_MODE`, its
    ``fused`` in interpret mode; else its ``gather`` run)."""
    r = ref_runs(mode, routing, replacement)
    p = T.simulate(scenario(T, routing, replacement), PortTrace(*qtrace),
                   mode=mode, device="cpu")
    assert_bitwise(r, p, (mode, routing, replacement))
    assert p.node.dtype == p.outcome.dtype == np.int32


@pytest.fixture(scope="module")
def port_run(qtrace):
    """The port's default run (``gather``, sticky, LRU) of the matrix's
    scenario on the CPU."""
    return T.simulate(scenario(T), PortTrace(*qtrace), device="cpu")


def test_matrix_scenario_contends(port_run):
    """The matrix's scenario exercises the miss path: evictions and
    drops both happen.  A static pool loses containers only by eviction,
    so more cold starts than the pools can ever hold at once (30 MB is
    the smallest container) means misses evicted."""
    p = port_run
    cfg = scenario(T).to_cluster_config()
    holdable = sum(min(cfg.max_slots, int(c // 30.0))
                   for c in cfg.pool_caps().ravel())
    assert int((p.outcome == MISS).sum()) > 2 * holdable
    assert (p.outcome == DROP).any()


def test_summary_keys_and_run_info(ref, qtrace, port_run):
    p = port_run
    assert tuple(p.summary()) == T.SUMMARY_KEYS == ref.SUMMARY_KEYS
    assert p.run_info["trace_fingerprint"] == ref.trace_fingerprint(qtrace)
    assert p.run_info["device"] == "cpu" and p.run_info["mode"] == "gather"
    assert p.fracs.shape == (1, 2)
    assert scenario(T).label == scenario(ref).label


def test_edge_trace_is_the_references(ref):
    from repro.workloads import edge_trace as ref_edge_trace
    for seed in (0, 3):
        a = ref_edge_trace(seed=seed, duration_s=600.0)
        b = edge_trace(seed=seed, duration_s=600.0)
        assert T.trace_fingerprint(b) == ref.trace_fingerprint(a)


def _digests(res) -> dict:
    def d(a):
        return hashlib.blake2s(
            np.ascontiguousarray(a, np.int32).tobytes()).hexdigest()
    return dict(node=d(res.node), outcome=d(res.outcome),
                counts=np.bincount(res.outcome, minlength=3).tolist())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_digests_are_the_references(ref):
    """``chip_smoke.py`` holds the card's full-size runs to constants;
    they are the reference's own results (``gather``) on the same trace
    head and scenarios.  The trace it cuts is the stored quickstart
    trace, which is the reference's ``edge_trace(seed=0,
    duration_s=3600)``."""
    from repro.cluster.presets import het16_cluster
    from repro.workloads import edge_trace as ref_edge_trace
    smoke = _chip_smoke()
    tr = ref_edge_trace(seed=0, duration_s=3600.0)
    stored = quickstart_trace()
    assert len(tr) == 11215
    for name, a, b in zip(tr._fields, tr, stored):
        if a is None:                       # the chain fields
            assert b is None, name
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ref.trace_fingerprint(tr) == smoke.GOLDEN_TRACE
    assert T.trace_fingerprint(stored) == smoke.GOLDEN_TRACE
    ref_scn = {"kiss4096": ref.Scenario.kiss(4096.0),
               "het16_size_aware": ref.Scenario.from_cluster(
                   het16_cluster("size_aware"))}
    port_scn = smoke.scenarios()
    assert set(ref_scn) == set(port_scn) == set(smoke.GOLDEN)
    for name, scn in ref_scn.items():
        assert port_scn[name].label == scn.label
        assert port_scn[name].max_slots == scn.max_slots
        assert _digests(ref.simulate(scn, tr.head(smoke.SIM_EVENTS),
                                     mode="gather")) \
            == smoke.GOLDEN[name], name


# ---------------------------------------------------------------------------
# the port's rules: no JAX, an explicit device, unported knobs refuse
# ---------------------------------------------------------------------------

def test_imports_without_jax_or_repro():
    """With ``jax`` unimportable, the port imports, runs tiny fused
    static, failure-injected and autoscaled simulates and one with
    telemetry and chains on the CPU, writes its manifest, and never
    loads a ``repro`` module."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        import repro_torch
        import repro_torch.kernels.pool_step
        import repro_torch.cluster.graphs
        from repro_torch.sim import Scenario, simulate
        from repro_torch.workloads import edge_trace, quickstart_trace
        tr = edge_trace(seed=0, duration_s=60.0)
        r = simulate(Scenario.kiss(1024.0, max_slots=16), tr,
                     mode="fused", device="cpu")
        assert r.summary()["total"] == len(tr) > 0
        f = simulate(Scenario.kiss(1024.0, max_slots=16,
                                   failures=((10.0, 30.0, 0),)), tr,
                     mode="fused", chunk_events=50, device="cpu")
        assert f.summary()["downtime_pct"] > 0
        a = simulate(Scenario.cluster((512.0, 1024.0), max_slots=16,
                                      autoscale={"epoch_events": 40,
                                                 "spawn_drop_frac": 0.05}),
                     tr, mode="fused", device="cpu")
        assert a.fracs.shape == (-(-len(tr) // 40), 2)
        import os, tempfile
        from repro_torch.sim import Chains
        from repro_torch.sim.telemetry import write_manifest
        from repro_torch.workloads import ChainConfig, chained_trace
        ctr = chained_trace(ChainConfig(duration_s=20.0))
        c = simulate(Scenario.cluster((512.0, 1024.0), max_slots=16,
                                      telemetry=16, chains=Chains(slack=2.0),
                                      routing="slack_aware"),
                     ctr, mode="fused", chunk_events=30, device="cpu")
        assert c.timeline().counts.sum() == len(ctr)
        assert c.summary()["n_chains"] == c.chain_metrics().n_chains > 0
        m = c.manifest()
        assert "torch" in m["versions"] and "jax" not in m["versions"]
        with tempfile.TemporaryDirectory() as d:
            write_manifest(m, os.path.join(d, "m.json"))
        bad = sorted(m for m, v in sys.modules.items() if v is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_import_in_port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch, qtrace):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.simulate(scenario(T), PortTrace(*qtrace))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_pool(PoolConfig(1024.0, Policy.LRU, 4))
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("knob", sorted(NOT_PORTED))
def test_unported_scenario_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match=NOT_PORTED[knob]):
        T.Scenario.kiss(1024.0, **{knob: object()})


def test_unported_engine_and_chunking_raise(qtrace):
    """``engine="ref"`` still raises; ``chunk_events`` is ported (A6), so
    only a bad value raises."""
    tr, scn = PortTrace(*qtrace), scenario(T)
    with pytest.raises(NotImplementedError, match="A14"):
        T.simulate(scn, tr, engine="ref", device="cpu")
    with pytest.raises(ValueError, match="chunk_events"):
        T.simulate(scn, tr, chunk_events=0, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        T.simulate(scn, tr, engine="jax", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        T.simulate(scn, tr, mode="scatter", device="cpu")


def test_registries_keep_the_references_codes(ref):
    assert T.routing_policies() == list(ROUTINGS)
    assert T.replacement_policies() == list(REPLACEMENTS)
    for name in ROUTINGS:
        assert T.ROUTING.resolve(name) == ref.ROUTING.resolve(name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_modes_match_cpu_without_host_syncs():
    """Every mode on the card equals the CPU run bitwise, with the loop
    under ``set_sync_debug_mode("error")``; ``fused`` launches the
    kernel once an event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    tr = edge_trace(seed=1, duration_s=120.0)
    for routing, replacement in (("size_aware", "greedy_dual"),
                                 ("cost_model", "lru")):
        scn = scenario(T, routing, replacement)
        cpu = T.simulate(scn, tr, device="cpu")
        torch.cuda.set_sync_debug_mode("error")
        try:
            for mode in STEP_MODES:
                before = evict_place_cuda.launches
                got = T.simulate(scn, tr, mode=mode, device="cuda")
                fused = evict_place_cuda.launches - before
                assert fused == (len(tr) if mode == "fused" else 0), mode
                assert np.array_equal(cpu.node, got.node), mode
                assert np.array_equal(cpu.outcome, got.outcome), mode
                assert cpu.summary() == got.summary(), mode
        finally:
            torch.cuda.set_sync_debug_mode(0)
