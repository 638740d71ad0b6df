"""Shared cluster presets (a copy of ``repro.cluster.presets``)."""
from __future__ import annotations

from ..core.continuum import ClusterConfig


def het16_cluster(routing, big_mb: float = 6144.0,
                  max_slots: int = 256, cloud_rtt_s: float = 0.5,
                  cloud_cold_prob: float = 0.25) -> ClusterConfig:
    """The 16-node heterogeneous benchmark cluster: 1/1/2/``big_mb`` GB
    nodes interleaved, all KiSS-split 80/20, in front of a priced cloud.
    ``routing`` is a registered routing name, code or enum member."""
    return ClusterConfig(
        node_mb=(1024.0, 1024.0, 2048.0, float(big_mb)) * 4,
        small_frac=(0.8,) * 16, unified=(False,) * 16, routing=routing,
        cloud_rtt_s=cloud_rtt_s, cloud_cold_prob=cloud_cold_prob,
        max_slots=max_slots)
