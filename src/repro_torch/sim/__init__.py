"""repro_torch.sim — the front door of the port: one Scenario, the
policy registries, one Result::

    from repro_torch.sim import Scenario, simulate, sweep
    from repro_torch.workloads import edge_trace

    trace = edge_trace(seed=0, duration_s=3600)
    kiss = simulate(Scenario.kiss(4 * 1024.0), trace)          # on CUDA
    kiss_cpu = simulate(Scenario.kiss(4 * 1024.0), trace, device="cpu")
    kiss.summary()["cold_start_pct"]
    grid = sweep(trace, [Scenario.kiss(m * 1024.0) for m in (2, 4, 8)])

A policy is one pure function ``fn(xp, ctx)`` on the numpy spelling;
``xp`` here is :mod:`repro_torch.core.xp`, so a body written for the
reference registers unchanged with ``register_routing``,
``register_replacement`` or ``register_resize_policy``.  Importing this
package registers ``cost_model`` and ``slack_aware`` (routing codes 4
and 5), as the reference's ``repro.sim`` does.
"""
from ..core.continuum import Autoscale, Failures
from ..core.registry import (REPLACEMENT, RESIZE, ROUTING, PolicySpec,
                             ResizeCtx, RouteCtx, SlotStats,
                             register_replacement, register_resize_policy,
                             register_routing, replacement_policies,
                             resize_policies, routing_policies)
from .api import simulate, sweep
from .chains import ChainMetrics, Chains
from .result import SUMMARY_KEYS, Result
from .scenario import Resize, Scenario
from .telemetry import (Telemetry, TelemetrySeries, run_manifest,
                        trace_fingerprint, write_manifest)
from . import policies  # registers cost_model, slack_aware  # noqa: F401

__all__ = [
    "Autoscale", "ChainMetrics", "Chains", "Failures", "REPLACEMENT",
    "RESIZE", "ROUTING", "PolicySpec", "Resize", "ResizeCtx", "Result",
    "RouteCtx", "SUMMARY_KEYS", "Scenario", "SlotStats", "Telemetry",
    "TelemetrySeries", "register_replacement", "register_resize_policy",
    "register_routing", "replacement_policies", "resize_policies",
    "routing_policies", "run_manifest", "simulate", "sweep",
    "trace_fingerprint", "write_manifest",
]
