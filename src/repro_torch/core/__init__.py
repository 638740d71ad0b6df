"""Core of the port: types, policy registries, the torch ``xp``
namespace, the continuum config and the warm pool."""
from .types import (DROP, HIT, LARGE, MISS, SMALL, ClassMetrics, KissConfig,
                    Policy, PoolConfig, SimResult, Trace)
from .registry import (REPLACEMENT, ROUTING, PolicySpec, RouteCtx,
                       SlotStats, register_replacement, register_routing,
                       replacement_policies, routing_policies)
from .continuum import (Autoscale, ChainPlan, ClusterConfig,
                        ContinuumResult, Failures, RoutingPolicy,
                        compile_chains)

__all__ = [
    "Autoscale", "ChainPlan", "DROP", "HIT", "LARGE", "MISS", "SMALL",
    "ClassMetrics", "ClusterConfig", "ContinuumResult", "Failures", "KissConfig", "Policy",
    "PolicySpec", "PoolConfig", "REPLACEMENT", "ROUTING", "RouteCtx", "RoutingPolicy",
    "SimResult", "SlotStats", "Trace", "register_replacement",
    "register_routing", "compile_chains", "replacement_policies",
    "routing_policies",
]
