"""Workload substrate (numpy), copied from ``repro.workloads``:
Azure-2019-like synthetic traces, the Azure-2019 schema's replay (CSV
ingest, a schema-faithful table generator), app populations and chained
invocations.  The benchmark traces are also stored as the reference
draws them under numpy 2.0 (``quickstart_trace``,
``benchmark_chained_trace``, ``benchmark_replay_trace``), and so are the
vertical benchmark's Azure tables (``benchmark_replay_tables``):
``Generator.zipf`` draws differently under numpy 2.3."""
from .azure import (TraceConfig, bursty_trace, edge_trace, quickstart_trace,
                    steady_trace, stress_trace, synthesize)
from .apps import AppPopulation, synthesize_apps
from .chains import ChainConfig, benchmark_chained_trace, chained_trace
from .replay import (AzureTables, ReplayConfig, SchemaConfig,
                     benchmark_replay_tables, benchmark_replay_trace,
                     load_azure_trace, read_azure_csvs,
                     synthesize_azure_schema, trace_from_tables,
                     write_azure_csvs)

__all__ = ["TraceConfig", "bursty_trace", "edge_trace", "steady_trace",
           "stress_trace", "synthesize", "AppPopulation", "synthesize_apps",
           "ChainConfig", "chained_trace", "AzureTables", "ReplayConfig",
           "SchemaConfig", "load_azure_trace", "read_azure_csvs",
           "synthesize_azure_schema", "trace_from_tables",
           "write_azure_csvs", "benchmark_chained_trace",
           "benchmark_replay_tables", "benchmark_replay_trace",
           "quickstart_trace"]
