"""The reference's deprecated entry points in the port, on the CPU: each
warns ``DeprecationWarning`` and returns what the reference's shim
returns on the same inputs (``SimResult`` summaries, the sweep grids'
metric arrays, ``ClusterResult`` arrays, ``ContinuumResult``, the
adaptive split trajectory), as ``tests/test_simulator.py`` and
``tests/test_sim_api.py`` hold the reference's shims.  The reference is
reached through fixtures, so the file also collects where JAX is
absent.
"""
import warnings

import numpy as np
import pytest

import repro_torch.cluster as PCl
import repro_torch.core as P
from repro_torch.core.adaptive import AdaptiveConfig, simulate_kiss_adaptive
from repro_torch.core.types import Trace as PortTrace

N_EVENTS = 400


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.core")


@pytest.fixture(scope="module")
def qtrace(ref):
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(9), N_EVENTS)


def call(fn, *args, **kw):
    """``fn(*args, **kw)``, which must warn ``DeprecationWarning``."""
    with pytest.warns(DeprecationWarning, match=fn.__name__):
        return fn(*args, **kw)


def quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


def same_class_metrics(r, p, what):
    assert r.small.__dict__ == p.small.__dict__, what
    assert r.large.__dict__ == p.large.__dict__, what
    assert r.summary() == p.summary(), what


@pytest.mark.parametrize("policy", ["LRU", "GREEDY_DUAL", "FREQ"])
def test_single_node_shims_match_the_reference(ref, qtrace, policy):
    pt = PortTrace(*qtrace)
    rp, pp = getattr(ref.Policy, policy), getattr(P.Policy, policy)
    rcfg = ref.KissConfig(total_mb=2048.0, small_frac=0.7, policy=rp,
                          max_slots=96)
    pcfg = P.KissConfig(total_mb=2048.0, small_frac=0.7, policy=pp,
                        max_slots=96)
    same_class_metrics(quiet(ref.simulate_kiss, rcfg, qtrace),
                       call(P.simulate_kiss, pcfg, pt), "kiss")
    same_class_metrics(quiet(ref.simulate_kiss_jax, rcfg, qtrace),
                       call(P.simulate_kiss_jax, pcfg, pt, device="cpu"),
                       "kiss_jax")
    same_class_metrics(
        quiet(ref.simulate_baseline, 1024.0, qtrace, rp, 96),
        call(P.simulate_baseline, 1024.0, pt, pp, 96), "baseline")
    same_class_metrics(
        quiet(ref.simulate_baseline_jax, 1024.0, qtrace, rp, 96),
        call(P.simulate_baseline_jax, 1024.0, pt, pp, 96, device="cpu"),
        "baseline_jax")


def test_single_node_oracle_keeps_per_pool_policies(ref, qtrace):
    """``simulate_kiss`` (the oracle) takes per-pool policy overrides, as
    the reference's does; the engine's shim refuses them."""
    rcfg = ref.KissConfig(total_mb=1536.0, policy=ref.Policy.LRU,
                          large_policy=ref.Policy.FREQ, max_slots=64)
    pcfg = P.KissConfig(total_mb=1536.0, policy=P.Policy.LRU,
                        large_policy=P.Policy.FREQ, max_slots=64)
    same_class_metrics(quiet(ref.simulate_kiss, rcfg, qtrace),
                       call(P.simulate_kiss, pcfg, PortTrace(*qtrace)),
                       "overrides")
    with pytest.raises(ValueError, match="per-pool policy"):
        quiet(P.simulate_kiss_jax, pcfg, PortTrace(*qtrace), device="cpu")


def test_sweep_grids_match_the_reference(ref, qtrace):
    pt = PortTrace(*qtrace)
    grid = ((1024.0, 3072.0), (0.8, 0.6), (0, 2))
    want = quiet(ref.sweep_kiss, qtrace, *grid, max_slots=64)
    got = call(P.sweep_kiss, pt, *grid, max_slots=64, device="cpu")
    assert got.dtype == want.dtype == np.float32 and got.shape == (8, 2, 4)
    assert got.tobytes() == want.tobytes()
    want = quiet(ref.sweep_baseline, qtrace, (768.0, 2048.0), (1, 2),
                 max_slots=64)
    got = call(P.sweep_baseline, pt, (768.0, 2048.0), (1, 2), max_slots=64,
               device="cpu")
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for row in got:
        r, p = ref.metrics_to_result(row), P.metrics_to_result(row)
        same_class_metrics(r, p, "metrics_to_result")


def same_cluster_result(r, p, what):
    for f in ("node", "outcome", "latencies", "per_node"):
        x, y = np.asarray(getattr(r, f)), getattr(p, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (what, f)
    assert r.latency_stats() == p.latency_stats(), what


def test_cluster_shims_match_the_reference(ref, qtrace):
    import repro.cluster as RCl
    pt = PortTrace(*qtrace)
    kw = dict(node_mb=(1024.0, 2048.0), small_frac=(0.8, 0.7),
              unified=(False, True), routing="least_loaded", max_slots=32)
    rcfg, pcfg = RCl.ClusterConfig(**kw), PCl.ClusterConfig(**kw)
    want = quiet(RCl.simulate_cluster_ref, rcfg, qtrace, 2)
    same_cluster_result(want, call(PCl.simulate_cluster_ref, pcfg, pt, 2),
                        "ref")
    same_cluster_result(
        want, call(PCl.simulate_cluster_jax, pcfg, pt, 2, "vmap",
                   device="cpu"), "jax")
    rcfgs = [rcfg, RCl.ClusterConfig(**{**kw, "routing": "sticky"})]
    pcfgs = [pcfg, PCl.ClusterConfig(**{**kw, "routing": "sticky"})]
    wants = quiet(RCl.sweep_cluster, qtrace, rcfgs, 1)
    gots = call(PCl.sweep_cluster, pt, pcfgs, 1, device="cpu")
    for r, p in zip(wants, gots):
        same_cluster_result(r, p, "sweep")


def test_simulate_continuum_matches_the_reference(ref, qtrace):
    import repro.core.continuum as RC
    kw = dict(n_nodes=3, node_mb=1024.0, kiss=True, small_frac=0.7,
              cloud_rtt_s=0.4, cloud_cold_prob=0.2)
    r = quiet(RC.simulate_continuum, RC.ContinuumConfig(**kw), qtrace, 5)
    p = call(P.simulate_continuum, P.ContinuumConfig(**kw),
             PortTrace(*qtrace), 5)
    assert r.edge.__dict__ == p.edge.__dict__
    assert r.cloud_offloads == p.cloud_offloads > 0
    assert r.latencies.tobytes() == p.latencies.tobytes()
    assert r.latency_stats() == p.latency_stats()
    assert r.offload_pct == p.offload_pct


def test_simulate_kiss_adaptive_matches_the_reference(ref, qtrace):
    from repro.core import adaptive as RA
    base = dict(total_mb=1536.0, small_frac=0.7, max_slots=64)
    rcfg = RA.AdaptiveConfig(ref.KissConfig(**base), epoch_events=64,
                             gain=0.25)
    pcfg = AdaptiveConfig(P.KissConfig(**base), epoch_events=64, gain=0.25)
    r_res, r_fracs = quiet(RA.simulate_kiss_adaptive, rcfg, qtrace)
    p_res, p_fracs = call(simulate_kiss_adaptive, pcfg, PortTrace(*qtrace),
                          device="cpu")
    same_class_metrics(r_res, p_res, "adaptive")
    assert p_fracs.dtype == r_fracs.dtype == np.float64
    assert p_fracs.shape == (-(-N_EVENTS // 64),)
    assert p_fracs.tobytes() == r_fracs.tobytes()
    assert len(np.unique(p_fracs)) > 1
    with pytest.raises(ValueError, match="inside"):
        quiet(simulate_kiss_adaptive,
              AdaptiveConfig(P.KissConfig(1024.0, small_frac=0.95)),
              PortTrace(*qtrace), device="cpu")
