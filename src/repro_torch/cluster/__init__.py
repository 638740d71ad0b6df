"""The cluster engine on torch: N heterogeneous nodes (two warm pools
each, stacked on one axis) in front of a priced cloud tier, one loop
over events; a sweep's lanes are a leading axis of the same step.  See
:mod:`repro_torch.cluster.engine`.  The numpy oracle with the same
semantics is ``cluster_outcomes_ref`` (from ``repro_torch.core.continuum``);
the ``simulate_cluster_*``/``sweep_cluster`` names are the reference's
deprecation shims, over the port's engine and the oracle."""
from ..core.continuum import (Autoscale, ClusterConfig, Failures,
                              RoutingPolicy, cloud_cold_draws,
                              cluster_outcomes_ref, continuum_latencies,
                              route_hashes)
from .engine import (STEP_MODES, ClusterEvent, check_step_mode,
                     cluster_events, init_cluster, simulate_cluster_jax,
                     simulate_cluster_ref, sweep_cluster)
from .metrics import ClusterResult, build_result
from .presets import het16_cluster

__all__ = [
    "Autoscale", "ClusterConfig", "Failures", "ClusterEvent", "ClusterResult", "RoutingPolicy",
    "STEP_MODES", "build_result", "check_step_mode", "cloud_cold_draws",
    "cluster_events", "cluster_outcomes_ref", "continuum_latencies",
    "het16_cluster", "init_cluster", "route_hashes",
    "simulate_cluster_jax", "simulate_cluster_ref", "sweep_cluster",
]
