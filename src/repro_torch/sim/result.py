"""The one result type every simulation returns (port of
``repro.sim.result``).

``summary()`` returns every key of the reference's :data:`SUMMARY_KEYS`,
in order.  The keys of vertical scaling, which the port does not run yet
(ROADMAP A11), take the inert values the reference reports when the
feature is off.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..cluster.metrics import ClusterResult
from ..core.continuum import ContinuumResult
from ..core.types import ClassMetrics, SimResult
from . import telemetry as _telemetry
from .chains import ChainMetrics
from .scenario import Scenario
from .telemetry import TelemetrySeries

#: The keys ``summary()`` always returns, in order — the reference's
#: benchmark-stable contract (see ``repro.sim.result.SUMMARY_KEYS`` for
#: each key's meaning).
SUMMARY_KEYS = (
    "cold_start_pct", "drop_pct", "hit_rate",
    "small_cold_start_pct", "large_cold_start_pct",
    "small_drop_pct", "large_drop_pct",
    "serviceable", "total", "exec_time_s", "serviceable_mean_s",
    "n_nodes", "offload_pct",
    "latency_mean_s", "latency_p50_s", "latency_p95_s", "latency_p99_s",
    "n_epochs", "frac_final_mean", "frac_min", "frac_max",
    "downtime_pct", "n_invalidated", "n_active_final", "n_active_min",
    "n_windows",
    "n_chains", "chain_latency_mean_s", "chain_p95_s",
    "deadline_miss_pct",
    "utilization_ratio", "bottleneck_events",
)


@dataclasses.dataclass(frozen=True)
class Result:
    """One simulation run: scenario + per-event outcomes, priced end to
    end.  ``node``/``outcome`` are i32[T] (routed node; 0 hit / 1 miss /
    2 drop->cloud), ``latencies`` f64[T] end-to-end seconds and
    ``per_node`` f64[N, 2, 4] (hits, misses, drops, edge exec time) per
    (node, size class); ``fracs`` f32[E, N] and ``active`` bool[E, N]
    are the autoscaler's per-epoch split and membership (one static row
    otherwise)."""

    scenario: Scenario
    raw: ClusterResult
    #: f32[E, N] per-epoch small-pool fractions from the autoscaler
    #: (``None`` for static scenarios: ``fracs`` derives the one-row view)
    epoch_fracs: np.ndarray | None = None
    #: bool[E, N] per-epoch membership from the node autoscaler (``None``
    #: for static scenarios: ``active`` derives the one-row view)
    epoch_active: np.ndarray | None = None
    #: bool[T, N] per-event live mask (``None`` without a failure
    #: schedule)
    node_up: np.ndarray | None = None
    #: i64[N] residents invalidated per node by failure recovery or
    #: retirement (``None`` = neither ran; the views report zeros)
    invalidated: np.ndarray | None = None
    #: the windowed time series (``None`` unless the scenario set
    #: ``telemetry=``); see :class:`repro_torch.sim.telemetry.TelemetrySeries`
    telemetry: TelemetrySeries | None = None
    #: per-chain accounting (``None`` unless the scenario set
    #: ``chains=``); see :class:`repro_torch.sim.chains.ChainMetrics`
    chains: ChainMetrics | None = None
    #: how this run was executed: engine, mode, chunking, device, rng
    #: seed and the trace fingerprint
    run_info: dict | None = None
    #: f32[E] event time at each epoch boundary (autoscaled runs only)
    epoch_t: np.ndarray | None = None

    # -- per-event arrays --------------------------------------------------
    @property
    def node(self) -> np.ndarray:
        return self.raw.node

    @property
    def outcome(self) -> np.ndarray:
        return self.raw.outcome

    @property
    def latencies(self) -> np.ndarray:
        return self.raw.latencies

    @property
    def per_node(self) -> np.ndarray:
        return self.raw.per_node

    def __len__(self) -> int:
        return len(self.raw.latencies)

    @property
    def fracs(self) -> np.ndarray:
        """f32[E, N] small-pool fraction in effect after each epoch: the
        autoscaler's trajectory (unified nodes pinned at their start), or
        for a static scenario one row at ``small_frac``."""
        if self.epoch_fracs is not None and len(self.epoch_fracs):
            return self.epoch_fracs
        return np.asarray([self.scenario.small_frac], np.float32)

    @property
    def active(self) -> np.ndarray:
        """bool[E, N] cluster membership after each epoch: the node
        autoscaler's trajectory, or one all-True row without one
        (membership is apart from failures, which ``node_up`` tracks)."""
        if self.epoch_active is not None and len(self.epoch_active):
            return self.epoch_active
        return np.ones((1, self.scenario.n_nodes), bool)

    @property
    def n_active(self) -> np.ndarray:
        """i64[E] active-node count per epoch."""
        return self.active.sum(axis=1)

    @property
    def node_downtime_pct(self) -> np.ndarray:
        """f64[N] percent of events each node spent down (failures)."""
        n = self.scenario.n_nodes
        if self.node_up is None or not len(self.node_up):
            return np.zeros(n)
        return 100.0 * (1.0 - self.node_up.mean(axis=0))

    @property
    def n_invalidated(self) -> int:
        """Total residents killed by recovery: each is a warm container
        some function must cold-start again (the re-warm debt)."""
        return (int(self.invalidated.sum())
                if self.invalidated is not None else 0)

    # -- per-class, per-node and latency views -----------------------------
    def per_class(self) -> SimResult:
        """Cluster-wide metrics split by size class."""
        return self.raw.per_class

    @property
    def overall(self) -> ClassMetrics:
        return self.raw.edge

    def node_metrics(self, n: int) -> ClassMetrics:
        return self.raw.node_metrics(n)

    def node_table(self) -> list[dict]:
        return self.raw.node_table()

    @property
    def cloud_offloads(self) -> int:
        return self.raw.cloud_offloads

    @property
    def offload_pct(self) -> float:
        return self.raw.offload_pct

    def latency_stats(self) -> dict:
        """End-to-end latency percentiles: mean/p50/p95/p99 seconds."""
        return self.raw.latency_stats()

    def as_continuum(self) -> ContinuumResult:
        return self.raw.as_continuum()

    def as_cluster(self) -> ClusterResult:
        return self.raw

    # -- observability views (repro_torch.sim.telemetry) -------------------
    def timeline(self) -> TelemetrySeries:
        """The windowed time series this run kept.

        Raises ``ValueError`` unless the scenario enabled it:
        ``Scenario(..., telemetry=Telemetry(window_events=N))`` (or just
        ``telemetry=N``)."""
        if self.telemetry is None:
            raise ValueError(
                "this run collected no telemetry — set "
                "Scenario(..., telemetry=Telemetry(window_events=N)) "
                "(or telemetry=N) and re-run")
        return self.telemetry

    def to_trace_events(self, path: str | None = None) -> dict:
        """Chrome trace-event / Perfetto JSON for this run: counter
        tracks per telemetry window plus outage and autoscale timeline
        tracks.  Works without telemetry too (timeline tracks only);
        ``path`` also writes the JSON to disk."""
        return _telemetry.trace_events(self, path)

    def manifest(self) -> dict:
        """The structured run manifest (scenario hash, trace fingerprint,
        engine, mode, chunking, device, versions, summary); see
        :func:`repro_torch.sim.telemetry.run_manifest`."""
        return _telemetry.run_manifest(self)

    # -- chain views (repro_torch.sim.chains) ------------------------------
    def chain_metrics(self) -> ChainMetrics:
        """The per-chain accounting this run kept.

        Raises ``ValueError`` unless the scenario enabled it
        (``Scenario(..., chains=Chains(...))``) on a chained trace."""
        if self.chains is None:
            raise ValueError(
                "this run tracked no chains — set "
                "Scenario(..., chains=Chains(...)) on a chained trace "
                "(Trace.has_chains) and re-run")
        return self.chains

    @property
    def chain_latency(self) -> np.ndarray:
        """f32[done] end-to-end latencies of the completed chains."""
        return self.chain_metrics().chain_latency

    @property
    def chain_p95_s(self) -> float:
        return self.chain_metrics().chain_p95_s

    @property
    def deadline_miss_pct(self) -> float:
        """Percent of completed chains that missed their deadline."""
        return self.chain_metrics().deadline_miss_pct

    # -- the benchmark-stable summary --------------------------------------
    def summary(self) -> dict:
        """Every key of :data:`SUMMARY_KEYS`, in order."""
        s = self.per_class().summary()
        lat = self.latency_stats()
        fr = self.fracs
        # frac stats describe the KiSS nodes' split; unified nodes' inert
        # small_frac is masked out (all-unified keeps the full view)
        kiss = [i for i, u in enumerate(self.scenario.unified) if not u]
        fr = fr[:, kiss] if kiss else fr
        n = self.scenario.n_nodes
        s.update({
            "n_nodes": n,
            "offload_pct": self.offload_pct,
            "latency_mean_s": lat["mean_s"],
            "latency_p50_s": lat["p50_s"],
            "latency_p95_s": lat["p95_s"],
            "latency_p99_s": lat["p99_s"],
            "n_epochs": int(fr.shape[0]),
            "frac_final_mean": float(fr[-1].mean()),
            "frac_min": float(fr.min()),
            "frac_max": float(fr.max()),
            "downtime_pct": float(self.node_downtime_pct.mean()),
            "n_invalidated": self.n_invalidated,
            "n_active_final": int(self.active[-1].sum()),
            "n_active_min": int(self.n_active.min()),
            "n_windows": (len(self.telemetry)
                          if self.telemetry is not None else 0),
            "n_chains": (self.chains.n_chains
                         if self.chains is not None else 0),
            "chain_latency_mean_s": (self.chains.chain_latency_mean_s
                                     if self.chains is not None else 0.0),
            "chain_p95_s": (self.chains.chain_p95_s
                            if self.chains is not None else 0.0),
            "deadline_miss_pct": (self.chains.deadline_miss_pct
                                  if self.chains is not None else 0.0),
            "utilization_ratio": 0.0,
            "bottleneck_events": 0,
        })
        if tuple(s) != SUMMARY_KEYS:
            raise RuntimeError(
                f"Result.summary() drifted from SUMMARY_KEYS: "
                f"{tuple(s)} != {SUMMARY_KEYS}")
        return s
