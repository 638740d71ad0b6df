"""Synthetic workloads (numpy), copied from ``repro.workloads``: the edge
trace and the chained trace, each with its benchmark trace stored as
drawn under numpy 2.0, and the vertical benchmark's Azure-replay trace,
stored.  The other generators there (bursty, steady, stress, apps, the
Azure replay's schema and loaders) are not ported yet (ROADMAP A14)."""
from .azure import TraceConfig, edge_trace, quickstart_trace, synthesize
from .chains import ChainConfig, benchmark_chained_trace, chained_trace
from .replay import benchmark_replay_trace

__all__ = ["ChainConfig", "TraceConfig", "benchmark_chained_trace",
           "benchmark_replay_trace", "chained_trace", "edge_trace",
           "quickstart_trace", "synthesize"]
