"""Cluster result assembly: per-node, per-class, and latency metrics.

A copy of ``repro.cluster.metrics``: a run reduces to two i32[T] host
arrays — routed node and outcome — and this module prices them into the
full result with numpy, exactly as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.continuum import (ClusterConfig, ContinuumResult,
                              continuum_latencies)
from ..core.types import DROP, HIT, MISS, ClassMetrics, SimResult, Trace


def _cm(row: np.ndarray) -> ClassMetrics:
    return ClassMetrics(hits=int(row[0]), misses=int(row[1]),
                        drops=int(row[2]), exec_time=float(row[3]))


@dataclasses.dataclass
class ClusterResult:
    """One cluster run: routed node + outcome per event, priced end to
    end.  ``per_node`` is f64[N, 2, 4] with columns (hits, misses, drops,
    edge_exec_time) per (node, size class)."""

    cfg: ClusterConfig
    node: np.ndarray          # i32[T] routed edge node
    outcome: np.ndarray       # i32[T] 0 hit / 1 miss / 2 drop->cloud
    latencies: np.ndarray     # f64[T] end-to-end seconds
    per_node: np.ndarray      # f64[N, 2, 4]

    @property
    def cloud_offloads(self) -> int:
        return int((self.outcome == DROP).sum())

    @property
    def offload_pct(self) -> float:
        n = len(self.latencies)
        return 100.0 * self.cloud_offloads / n if n else 0.0

    @property
    def edge(self) -> ClassMetrics:
        return _cm(self.per_node.sum(axis=(0, 1)))

    @property
    def per_class(self) -> SimResult:
        agg = self.per_node.sum(axis=0)
        return SimResult(small=_cm(agg[0]), large=_cm(agg[1]))

    def node_metrics(self, n: int) -> ClassMetrics:
        return _cm(self.per_node[n].sum(axis=0))

    def latency_stats(self) -> dict:
        return self.as_continuum().latency_stats()

    def node_table(self) -> list[dict]:
        """Per-node utilization summary (events, hit/drop rates)."""
        rows = []
        for n in range(self.cfg.n_nodes):
            m = self.node_metrics(n)
            rows.append({"node": n, "node_mb": self.cfg.node_mb[n],
                         "unified": self.cfg.unified[n],
                         "events": m.total_accesses,
                         "hit_rate": m.hit_rate, "drop_pct": m.drop_pct})
        return rows

    def as_continuum(self) -> ContinuumResult:
        return ContinuumResult(edge=self.edge,
                               cloud_offloads=self.cloud_offloads,
                               latencies=self.latencies)


def build_result(cfg: ClusterConfig, trace: Trace, node: np.ndarray,
                 outcome: np.ndarray, cloud_cold: np.ndarray) -> ClusterResult:
    node = np.asarray(node, np.int64)
    outcome = np.asarray(outcome, np.int64)
    cls = np.asarray(trace.cls, np.int64)
    warm = np.asarray(trace.warm_dur, np.float64)
    cold = np.asarray(trace.cold_dur, np.float64)
    latencies = continuum_latencies(trace, outcome, cloud_cold,
                                    cfg.cloud_rtt_s)
    per_node = np.zeros((cfg.n_nodes, 2, 4), np.float64)
    np.add.at(per_node, (node, cls, outcome), 1.0)
    edge_exec = np.where(outcome == HIT, warm,
                         np.where(outcome == MISS, cold, 0.0))
    np.add.at(per_node, (node, cls, np.full_like(node, 3)), edge_exec)
    return ClusterResult(cfg=cfg, node=node.astype(np.int32),
                         outcome=outcome.astype(np.int32),
                         latencies=latencies, per_node=per_node)
