"""Core of the port: types, policy registries, the torch ``xp``
namespace, the continuum config and its numpy oracle, the warm pools,
the workload analyzer and the reference's deprecated single-node entry
points (``simulator_ref``: the numpy oracles; ``legacy``: the
reference's ``simulator_jax`` names over the port's engine;
``adaptive``: ``simulate_kiss_adaptive``)."""
from .types import (DROP, HIT, LARGE, MISS, SMALL, ClassMetrics, KissConfig,
                    Policy, PoolConfig, SimResult, Trace)
from .registry import (REPLACEMENT, ROUTING, PolicySpec, RouteCtx,
                       SlotStats, register_replacement, register_routing,
                       replacement_policies, routing_policies)
from .simulator_ref import simulate_baseline, simulate_kiss
from .legacy import (metrics_to_result, simulate_baseline_jax,
                     simulate_kiss_jax, sweep_baseline, sweep_kiss)
from .analyzer import WorkloadProfile, analyze, classify
from .continuum import (Autoscale, ChainPlan, ClusterConfig,
                        ContinuumConfig, ContinuumResult, Failures,
                        RoutingPolicy, cluster_outcomes_ref, compile_chains,
                        simulate_continuum)

__all__ = [
    "Autoscale", "ChainPlan", "DROP", "HIT", "LARGE", "MISS", "SMALL",
    "ClassMetrics", "ClusterConfig", "ContinuumConfig", "ContinuumResult",
    "Failures", "KissConfig", "Policy", "PolicySpec", "PoolConfig",
    "REPLACEMENT", "ROUTING", "RouteCtx", "RoutingPolicy", "SimResult",
    "SlotStats", "Trace", "WorkloadProfile", "analyze", "classify",
    "cluster_outcomes_ref", "compile_chains", "metrics_to_result",
    "register_replacement", "register_routing", "replacement_policies",
    "routing_policies", "simulate_baseline", "simulate_baseline_jax",
    "simulate_continuum", "simulate_kiss", "simulate_kiss_jax",
    "sweep_baseline", "sweep_kiss",
]
