"""The reference's single-node JAX entry points, as deprecation shims
over the port's engine.

Each name is the reference's, kept for API parity only: ``_jax`` names
the engine the reference ran, while here each runs the port's torch
engine (``repro_torch.sim.simulate``/``sweep``, on ``device``; ``None``
is the CUDA device) and returns the reference's types:

* ``simulate_baseline_jax`` — ``repro/core/simulator_jax.py:72``;
* ``simulate_kiss_jax`` — ``repro/core/simulator_jax.py:109``;
* ``sweep_kiss`` — ``repro/core/simulator_jax.py:121``;
* ``sweep_baseline`` — ``repro/core/simulator_jax.py:145``;
* ``metrics_to_result`` — ``repro/core/simulator_jax.py:157``.

Metrics are per size class as an f32[2, 4] array with columns (hits,
misses, drops, exec_time), accumulated in float32 in event order as the
reference's scan accumulates them, so a ``SimResult`` here equals the
reference shim's (counts are exact below 2**24 events a class).
"""
from __future__ import annotations

import numpy as np

from .compat import deprecated
from .types import (HIT, MISS, ClassMetrics, KissConfig, Policy, SimResult,
                    Trace)


def _class_metrics(trace: Trace, outcome: np.ndarray) -> np.ndarray:
    """f32[2, 4] (hits, misses, drops, exec_time) per size class: counts
    as float32, the execution time (warm on a hit, cold on a miss, 0 on
    a drop) summed one event at a time in float32."""
    cls = np.asarray(trace.cls)
    exec_t = np.where(outcome == HIT, np.asarray(trace.warm_dur, np.float32),
                      np.where(outcome == MISS,
                               np.asarray(trace.cold_dur, np.float32),
                               np.float32(0.0)))
    metrics = np.zeros((2, 4), np.float32)
    for c in (0, 1):
        sel = cls == c
        metrics[c, :3] = np.bincount(outcome[sel], minlength=3)[:3]
        if sel.any():
            metrics[c, 3] = np.add.accumulate(exec_t[sel])[-1]
    return metrics


def _to_result(metrics: np.ndarray) -> SimResult:
    def cm(row):
        return ClassMetrics(hits=int(row[0]), misses=int(row[1]),
                            drops=int(row[2]), exec_time=float(row[3]))
    return SimResult(small=cm(metrics[0]), large=cm(metrics[1]))


def _kiss_scenario(cfg: KissConfig):
    from ..sim import Scenario
    if cfg.small_policy is not None or cfg.large_policy is not None:
        raise ValueError("per-pool policy overrides are not supported by "
                         "the scenario path; use simulate_kiss (the numpy "
                         "oracle)")
    return Scenario.kiss(cfg.total_mb, small_frac=cfg.small_frac,
                         replacement=cfg.policy, max_slots=cfg.max_slots)


def _sweep_metrics(trace: Trace, scenarios, device) -> np.ndarray:
    from ..sim import sweep
    return np.stack([_class_metrics(trace, r.outcome)
                     for r in sweep(trace, scenarios, device=device)])


@deprecated("repro_torch.sim.simulate(Scenario.baseline(...))")
def simulate_baseline_jax(total_mb: float, trace: Trace,
                          policy: Policy = Policy.LRU,
                          max_slots: int = 1024, device=None) -> SimResult:
    from ..sim import Scenario
    scn = Scenario.baseline(total_mb, replacement=policy,
                            max_slots=max_slots)
    return _to_result(_sweep_metrics(trace, [scn], device)[0])


@deprecated("repro_torch.sim.simulate(Scenario.kiss(...))")
def simulate_kiss_jax(cfg: KissConfig, trace: Trace,
                      device=None) -> SimResult:
    return _to_result(_sweep_metrics(trace, [_kiss_scenario(cfg)],
                                     device)[0])


@deprecated("repro_torch.sim.sweep(trace, [Scenario.kiss(...), ...])")
def sweep_kiss(trace: Trace, total_mbs, small_fracs, policies,
               max_slots: int = 1024, device=None) -> np.ndarray:
    """Every (total_mb, small_frac, policy) KiSS configuration of a
    cartesian grid as the lanes of one sweep.  Returns f32[G, 2, 4]
    metrics, G = len(total_mbs) * len(small_fracs) * len(policies) in
    row-major grid order."""
    grid = [KissConfig(total_mb=tm, small_frac=fr, policy=Policy(po),
                       max_slots=max_slots)
            for tm in total_mbs for fr in small_fracs for po in policies]
    return _sweep_metrics(trace, [_kiss_scenario(c) for c in grid], device)


@deprecated("repro_torch.sim.sweep(trace, [Scenario.baseline(...), ...])")
def sweep_baseline(trace: Trace, total_mbs, policies,
                   max_slots: int = 1024, device=None) -> np.ndarray:
    """Baseline analogue of ``sweep_kiss``: f32[G, 2, 4] over the
    (total_mb, policy) grid."""
    from ..sim import Scenario
    return _sweep_metrics(trace, [
        Scenario.baseline(tm, replacement=Policy(po), max_slots=max_slots)
        for tm in total_mbs for po in policies], device)


def metrics_to_result(metrics_row: np.ndarray) -> SimResult:
    return _to_result(np.asarray(metrics_row))
