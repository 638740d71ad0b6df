"""Pure-Python reference discrete-event simulator (sequential oracle);
a copy of ``repro.core.simulator_ref`` over the port's ``WarmPool``.

``simulate_baseline``  — one unified warm pool (the paper's baseline).
``simulate_kiss``      — the KiSS policy: two pools split small/large.

Both are deprecated entrypoints: the scenario front door
(``repro_torch.sim.simulate(Scenario.baseline(...), engine="ref")``)
supersedes them.  They are the single-node oracles, kept as the
reference keeps them.
"""
from __future__ import annotations

from .compat import deprecated
from .pool_ref import WarmPool
from .types import (LARGE, SMALL, ClassMetrics, KissConfig, Policy,
                    PoolConfig, SimResult, Trace)


def _run(pools, route, trace: Trace) -> SimResult:
    metrics = [ClassMetrics(), ClassMetrics()]  # [small, large]
    n = len(trace)
    for i in range(n):
        cls = int(trace.cls[i])
        pool = pools[route(cls)]
        pool.access(float(trace.t[i]), int(trace.func_id[i]),
                    float(trace.size_mb[i]), float(trace.warm_dur[i]),
                    float(trace.cold_dur[i]), metrics[cls])
    return SimResult(small=metrics[SMALL], large=metrics[LARGE])


@deprecated("repro_torch.sim.simulate(Scenario.baseline(...), engine='ref')")
def simulate_baseline(total_mb: float, trace: Trace, policy=None,
                      max_slots: int = 1024) -> SimResult:
    cfg = PoolConfig(total_mb, policy if policy is not None else Policy.LRU,
                     max_slots)
    pool = WarmPool(cfg)
    return _run([pool], lambda cls: 0, trace)


@deprecated("repro_torch.sim.simulate(Scenario.kiss(...), engine='ref')")
def simulate_kiss(cfg: KissConfig, trace: Trace) -> SimResult:
    small = WarmPool(cfg.small_pool)
    large = WarmPool(cfg.large_pool)
    return _run([small, large], lambda cls: cls, trace)
