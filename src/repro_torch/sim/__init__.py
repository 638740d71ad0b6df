"""repro_torch.sim — the front door of the port: one Scenario, the
policy registries, one Result::

    from repro_torch.sim import Scenario, simulate
    from repro_torch.workloads import edge_trace

    trace = edge_trace(seed=0, duration_s=3600)
    kiss = simulate(Scenario.kiss(4 * 1024.0), trace)          # on CUDA
    kiss_cpu = simulate(Scenario.kiss(4 * 1024.0), trace, device="cpu")
    kiss.summary()["cold_start_pct"]

A policy is one pure function ``fn(xp, ctx)`` on the numpy spelling;
``xp`` here is :mod:`repro_torch.core.xp`, so a body written for the
reference registers unchanged with ``register_routing`` /
``register_replacement``.  Importing this package registers
``cost_model`` and ``slack_aware`` (routing codes 4 and 5), as the
reference's ``repro.sim`` does.
"""
from ..core.continuum import Autoscale, Failures
from ..core.registry import (REPLACEMENT, ROUTING, PolicySpec, RouteCtx,
                             SlotStats, register_replacement,
                             register_routing, replacement_policies,
                             routing_policies)
from .api import simulate
from .chains import ChainMetrics, Chains
from .result import SUMMARY_KEYS, Result
from .scenario import Scenario
from .telemetry import Telemetry, TelemetrySeries, trace_fingerprint
from . import policies  # registers cost_model, slack_aware  # noqa: F401

__all__ = [
    "Autoscale", "ChainMetrics", "Chains", "Failures", "REPLACEMENT",
    "ROUTING", "PolicySpec", "Result", "RouteCtx", "SUMMARY_KEYS",
    "Scenario", "SlotStats", "Telemetry", "TelemetrySeries",
    "register_replacement", "register_routing", "replacement_policies",
    "routing_policies", "simulate", "trace_fingerprint",
]
