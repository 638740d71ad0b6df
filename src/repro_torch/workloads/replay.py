"""The Azure-replay benchmark's trace, stored.

``benchmarks/vertical.py`` replays ``trace_from_tables(
synthesize_azure_schema(SchemaConfig(n_funcs=400, n_minutes=240,
rpm_total=700.0, seed=0)))`` of the reference's ``repro.workloads.replay``:
192,047 invocations of 400 functions over four simulated hours, on a
1/64 s grid with whole-MB sizes.  The generator draws its popularity
with ``Generator.zipf``, whose stream numpy 2.3 changed, so the trace is
stored as the reference drew it under numpy 2.0 and loaded here; the
schema generator and the Azure CSV loaders themselves are not ported
yet (ROADMAP A14).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.types import Trace

BENCHMARK_REPLAY_FILE = Path(__file__).with_name(
    "azure_replay_seed0_240min.npz")


def benchmark_replay_trace() -> Trace:
    """The vertical benchmark's replay trace, loaded from
    :data:`BENCHMARK_REPLAY_FILE` (the same arrays under every numpy)."""
    with np.load(BENCHMARK_REPLAY_FILE) as z:
        return Trace(t=z["t"], func_id=z["func_id"], size_mb=z["size_mb"],
                     cls=z["cls"], warm_dur=z["warm_dur"],
                     cold_dur=z["cold_dur"])
