"""Synthetic workloads (numpy), copied from ``repro.workloads``; the
other generators there (bursty, steady, stress, chains, Azure replay)
are not ported yet (ROADMAP A14)."""
from .azure import TraceConfig, edge_trace, quickstart_trace, synthesize

__all__ = ["TraceConfig", "edge_trace", "quickstart_trace", "synthesize"]
