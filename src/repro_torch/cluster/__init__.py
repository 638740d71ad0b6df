"""The cluster engine on torch: N heterogeneous nodes (two warm pools
each, stacked on one axis) in front of a priced cloud tier, one loop
over events; a sweep's lanes are a leading axis of the same step.  See
:mod:`repro_torch.cluster.engine`."""
from ..core.continuum import (Autoscale, ClusterConfig, Failures,
                              RoutingPolicy, cloud_cold_draws,
                              continuum_latencies, route_hashes)
from .engine import (STEP_MODES, ClusterEvent, check_step_mode,
                     cluster_events, init_cluster)
from .metrics import ClusterResult, build_result
from .presets import het16_cluster

__all__ = [
    "Autoscale", "ClusterConfig", "Failures", "ClusterEvent", "ClusterResult", "RoutingPolicy",
    "STEP_MODES", "build_result", "check_step_mode", "cloud_cold_draws",
    "cluster_events", "continuum_latencies", "het16_cluster",
    "init_cluster", "route_hashes",
]
