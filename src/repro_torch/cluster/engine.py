"""Cluster engine on torch: N heterogeneous nodes, one loop over events.

The port of the static path of ``repro.cluster.engine``.  Every node owns
two warm pools (a unified node uses pool 0 with the whole node memory and
a zero-capacity pool 1), and all ``2N`` pools are stacked on one leading
axis of a single :class:`PoolState`.  Per event:

1. each node's load signal (``free``/``capacity`` of the pool that would
   serve this request) is read across the stacked axis;
2. the routing policy picks a node.  The reference's ``lax.switch`` over
   the routing registry becomes: evaluate every registered policy, stack
   the answers, select by the routing code, which stays data;
3. the routed pool takes the step (:data:`STEP_MODES`, bitwise equal):

   * ``"gather"`` — the routed pool's row is gathered out of the stack,
     stepped as a one-pool batch and written back: O(slots) per event;
   * ``"vmap"`` — every pool steps against the event (the reference's
     ``jax.vmap(pool_step)``, here the batch axis written out) with the
     sort composite ``"lax"``, and only the routed row is kept;
   * ``"fused"`` — the same all-pools step with the evict-and-place
     decision in the hand-written CUDA kernel (the ``"fused"`` step
     backend of ``repro_torch.kernels.pool_step``).

The reference's ``lax.scan`` becomes a host loop over events.  The loop
never reads a device value back: it indexes with tensors only
(``index_select``/``gather``/``where``), writes each event's node and
outcome into preallocated device tensors, and the results cross to the
host once, at the end.  Loading the inputs and that final copy are the
run's only sync points (``_device.sync_point``).  Pool state is updated
in place in gather mode.

Not ported yet: failures (ROADMAP A5), chunked runs (A6), autoscaling
(A8), telemetry (A9), chains (A10), vertical scaling (A11), sweeps (A12).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device, sync_point
from ..core import xp
from ..core.continuum import ClusterConfig, cloud_cold_draws, route_hashes
from ..core.pool import (Event, PoolState, _evict_place_lax,
                         get_step_backend, init_pool, pool_step_batch,
                         stack_pools)
from ..core.registry import ROUTING, RouteCtx
from ..core.types import PoolConfig, Trace
from .metrics import ClusterResult, build_result

#: The step formulations, in documentation order.
STEP_MODES = ("gather", "vmap", "fused")


def check_step_mode(mode: str) -> None:
    """Validate a step mode (the one place the rule lives)."""
    if mode not in STEP_MODES:
        raise ValueError(
            f"mode must be one of {STEP_MODES}, got {mode!r}")


class ClusterEvent(NamedTuple):
    """One invocation plus its precomputed node hashes (0-d tensors), or
    a whole trace of them (``[T]`` tensors)."""

    t: torch.Tensor
    func_id: torch.Tensor
    size: torch.Tensor
    cls: torch.Tensor
    warm: torch.Tensor
    cold: torch.Tensor
    h1: torch.Tensor     # sticky hash: func_id % n_nodes
    h2: torch.Tensor     # second (Knuth multiplicative) hash


def cluster_events(trace: Trace, n_nodes: int, device) -> ClusterEvent:
    """The trace as ``[T]`` device tensors, each with the reference's
    dtype (f32 times and sizes, i32 ids, classes and hashes)."""
    h1, h2 = route_hashes(trace.func_id, n_nodes)
    f32, i32 = torch.float32, torch.int32

    def col(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return ClusterEvent(
        t=col(trace.t, f32), func_id=col(trace.func_id, i32),
        size=col(trace.size_mb, f32), cls=col(trace.cls, i32),
        warm=col(trace.warm_dur, f32), cold=col(trace.cold_dur, f32),
        h1=col(h1, i32), h2=col(h2, i32))


def init_cluster(cfg: ClusterConfig, device) -> PoolState:
    """Stack all 2N pools of the cluster on a leading axis."""
    caps = cfg.pool_caps()
    return stack_pools([
        init_pool(PoolConfig(caps[n, k], cfg.policy, cfg.max_slots), device)
        for n in range(cfg.n_nodes) for k in range(2)])


def _route(routing: torch.Tensor, ev: ClusterEvent, free_t, cap_t, cloud,
           node_up, chain_slack, chain_stage) -> torch.Tensor:
    """The routing decision: every registered policy runs on the event's
    :class:`RouteCtx` (the same bodies as the reference's, on the torch
    ``xp``; the per-node arrays are :class:`~repro_torch.core.xp.XTensor`),
    and ``routing`` (an int64[1] code tensor) selects one.  Returns the
    node as an int64[1] tensor."""
    ctx = RouteCtx(h1=ev.h1, h2=ev.h2, size=ev.size, cls=ev.cls,
                   warm=ev.warm, cold=ev.cold, free=xp.asx(free_t),
                   cap=xp.asx(cap_t), cloud_rtt_s=cloud[0],
                   cloud_cold_prob=cloud[1], node_up=node_up,
                   chain_slack=chain_slack, chain_stage=chain_stage)
    nodes = torch.stack([spec.fn(xp, ctx).reshape(()).to(torch.int64)
                         for spec in ROUTING.specs()])
    return nodes.index_select(0, routing).as_subclass(torch.Tensor)


def _make_step(routing: torch.Tensor, unified: torch.Tensor,
               cloud: torch.Tensor, n_nodes: int, mode: str):
    """Build the per-event step (route, then step the routed pool).
    ``routing`` is the int64[1] routing code, ``unified`` bool[N] and
    ``cloud`` the f32[2] ``(cloud_rtt_s, cloud_cold_prob)``, all on the
    run's device."""
    n = n_nodes
    dev = unified.device
    all_up = xp.asx(torch.ones(n, dtype=torch.bool, device=dev))
    # constants are filled on the device: no host copy inside the loop
    no_slack = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    no_stage = torch.full((), -1, dtype=torch.int32, device=dev)
    pool_ids = torch.arange(2 * n, device=dev)
    cloud = tuple(cloud)          # (rtt, cold_prob) as 0-d views, once
    # any mode beyond gather/vmap is a step backend, resolved once here
    backend = (_evict_place_lax if mode in ("gather", "vmap")
               else get_step_backend(mode))

    def step(pools: PoolState, ev: ClusterEvent):
        tgt = torch.where(unified, 0, ev.cls).to(torch.int64)  # [N] pool
        col = tgt.unsqueeze(1)
        free_t = pools.free.view(n, 2).gather(1, col).squeeze(1)
        cap_t = pools.capacity.view(n, 2).gather(1, col).squeeze(1)
        node = _route(routing, ev, free_t, cap_t, cloud, all_up, no_slack,
                      no_stage)                               # [1]
        p = node * 2 + tgt.index_select(0, node)              # [1]
        core_ev = Event(ev.t, ev.func_id, ev.size, ev.cls, ev.warm, ev.cold)
        if mode == "gather":
            one = PoolState(*(None if a is None else a.index_select(0, p)
                              for a in pools))
            new_one, outcome = pool_step_batch(one, core_ev, backend)
            for a, b in zip(pools, new_one):
                if a is not None:
                    a.index_copy_(0, p, b)
        else:
            stepped, outs = pool_step_batch(pools, core_ev, backend)
            sel = pool_ids == p
            pools = PoolState(*(
                None if a is None else torch.where(
                    sel.view((-1,) + (1,) * (a.ndim - 1)), b, a)
                for a, b in zip(pools, stepped)))
            outcome = outs.index_select(0, p)
        return pools, node, outcome

    return step


def _run_cluster_impl(pools: PoolState, events: ClusterEvent,
                      routing: torch.Tensor, unified: torch.Tensor,
                      cloud: torch.Tensor, *, n_nodes: int, mode: str):
    """The whole trace, one event at a time, without a host sync.
    Returns ``(node i32[T], outcome i32[T])`` on the device."""
    step = _make_step(routing, unified, cloud, n_nodes, mode)
    n_ev = events.t.shape[0]
    dev = events.t.device
    nodes = torch.empty(n_ev, dtype=torch.int32, device=dev)
    outcomes = torch.empty(n_ev, dtype=torch.int32, device=dev)
    for i in range(n_ev):
        ev = ClusterEvent(*(a[i] for a in events))
        pools, node, outcome = step(pools, ev)
        nodes[i:i + 1].copy_(node)
        outcomes[i:i + 1].copy_(outcome)
    return nodes, outcomes


def _simulate_cluster_torch(cfg: ClusterConfig, trace: Trace,
                            device, rng_seed: int = 0,
                            mode: str = "gather") -> ClusterResult:
    """One static cluster run on ``device`` (required: the caller has
    resolved it); the ``ClusterResult``."""
    check_step_mode(mode)
    device = resolve_device(device)
    cloud_cold = cloud_cold_draws(len(trace), cfg.cloud_cold_prob, rng_seed)
    with sync_point(device):
        pools = init_cluster(cfg, device)
        events = cluster_events(trace, cfg.n_nodes, device)
        routing = torch.tensor([int(cfg.routing)], dtype=torch.int64,
                               device=device)
        unified = torch.tensor(cfg.unified, dtype=torch.bool, device=device)
        cloud = torch.tensor([cfg.cloud_rtt_s, cfg.cloud_cold_prob],
                             dtype=torch.float32, device=device)
    node, outcome = _run_cluster_impl(pools, events, routing, unified, cloud,
                                      n_nodes=cfg.n_nodes, mode=mode)
    with sync_point(device):
        node, outcome = node.cpu().numpy(), outcome.cpu().numpy()
    return build_result(cfg, trace, node, outcome, cloud_cold)
