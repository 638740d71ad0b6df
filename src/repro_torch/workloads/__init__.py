"""Synthetic workloads (numpy), copied from ``repro.workloads``: the edge
trace and the chained trace, each with its benchmark trace stored as
drawn under numpy 2.0.  The other generators there (bursty, steady,
stress, apps, Azure replay) are not ported yet (ROADMAP A14)."""
from .azure import TraceConfig, edge_trace, quickstart_trace, synthesize
from .chains import ChainConfig, benchmark_chained_trace, chained_trace

__all__ = ["ChainConfig", "TraceConfig", "benchmark_chained_trace",
           "chained_trace", "edge_trace", "quickstart_trace", "synthesize"]
