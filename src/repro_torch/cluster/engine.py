"""Cluster engine on torch: N heterogeneous nodes, one loop over events.

The port of ``repro.cluster.engine`` (static, failure-injected and
chunked runs).  Every node owns two warm pools (a unified node uses pool
0 with the whole node memory and a zero-capacity pool 1), and all ``2N``
pools are stacked on one leading axis of a single :class:`PoolState`.
Per event:

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

A failure schedule (``Failures``) is compiled on the host into per-event
``up``/``recover`` bool[T, N] masks: each event first clears the pools
of a node recovering at it (:func:`_invalidate_nodes`, counting the
residents killed), then routes with ``RouteCtx.node_up`` set to its
``up`` row; a request routed to a down node drops to the cloud and no
pool of a down node changes.

The reference's ``lax.scan`` becomes a loop over events that never
reads a device value back: it indexes with tensors only
(``index_select``/``gather``/``where``) and writes each event's node and
outcome into preallocated device tensors.  On the CPU a monolithic run
is that loop on the host (:func:`_run_events`).  Every other run goes
through the block runner of :mod:`repro_torch.cluster.graphs`, chunk by
chunk (``chunk_events``; on the card a monolithic run is one chunk of
the whole trace): the events stay in host numpy, one chunk at a time is
uploaded, its blocks of ``BLOCK_EVENTS`` events run as one CUDA graph
replay each (eagerly on the CPU), the chunk's last ``c mod K`` events
run eagerly, the pool state is carried in place from chunk to chunk (the
reference's donated carry), and the chunk's outputs are read back.
Uploads and read-backs are the run's only sync points
(``_device.sync_point``).

An autoscaled run (``Autoscale``, the reference's
``_run_autoscale_impl``) is a host loop over epochs of
``epoch_events``: each epoch's events run on one carry (on the card
through the block runner, as one chunk; on the CPU through the host
loop), with the membership mask ``active`` as the step's live mask
(``up & active`` with failures) and each event adding its pressure
(misses + 2x drops per routed node and size class, and the drops) to
the carry.  After a full epoch :func:`_epoch_end` re-splits every KiSS
node, resizes the pools (:func:`~repro_torch.core.pool.pool_resize`) and
spawns or retires at most one node, all on the device without a sync,
and writes the new state back into the carry in place.  A trailing
partial epoch runs unpadded and ends with no re-split.

Not ported yet: telemetry (ROADMAP A9), chains (A10), vertical scaling
(A11), sweeps (A12).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device, sync_point
from ..core import xp
from ..core.continuum import (Autoscale, ClusterConfig, Failures,
                              cloud_cold_draws, route_hashes)
from ..core.pool import (Event, PoolState, _evict_place_lax, _first_true,
                         _select, get_step_backend, init_pool, pool_resize,
                         pool_step_batch, stack_pools)
from ..core.registry import ROUTING, RouteCtx
from ..core.types import DROP, MISS, PoolConfig, Trace
from .metrics import ClusterResult, build_result

#: The step formulations, in documentation order.
STEP_MODES = ("gather", "vmap", "fused")


def check_step_mode(mode: str) -> None:
    """Validate a step mode (the one place the rule lives)."""
    if mode not in STEP_MODES:
        raise ValueError(
            f"mode must be one of {STEP_MODES}, got {mode!r}")


def check_chunk_events(chunk_events) -> int | None:
    """Validate (and normalize) a ``chunk_events`` argument."""
    if chunk_events is None:
        return None
    try:
        ok = int(chunk_events) == chunk_events and chunk_events >= 1
    except (TypeError, ValueError):
        ok = False
    if not ok:
        raise ValueError("chunk_events must be a positive integer or None, "
                         f"got {chunk_events!r}")
    return int(chunk_events)


class ClusterEvent(NamedTuple):
    """One invocation plus its precomputed node hashes (0-d tensors), or
    a whole trace of them (``[T]`` arrays)."""

    t: torch.Tensor
    func_id: torch.Tensor
    size: torch.Tensor
    cls: torch.Tensor
    warm: torch.Tensor
    cold: torch.Tensor
    h1: torch.Tensor     # sticky hash: func_id % n_nodes
    h2: torch.Tensor     # second (Knuth multiplicative) hash


def _host_events(trace: Trace, n_nodes: int) -> ClusterEvent:
    """The trace as ``[T]`` numpy columns with the reference's dtypes
    (f32 times and sizes, i32 ids, classes and hashes); a chunked run
    uploads one slice of them at a time."""
    h1, h2 = route_hashes(trace.func_id, n_nodes)
    return ClusterEvent(
        t=np.asarray(trace.t, np.float32),
        func_id=np.asarray(trace.func_id, np.int32),
        size=np.asarray(trace.size_mb, np.float32),
        cls=np.asarray(trace.cls, np.int32),
        warm=np.asarray(trace.warm_dur, np.float32),
        cold=np.asarray(trace.cold_dur, np.float32),
        h1=h1, h2=h2)


def _upload(arrays, s: int, e: int, device) -> tuple:
    """Events ``[s, e)`` of host arrays as tensors on ``device`` (the
    reference's ``_chunk_slice``/``_chunk_mask``, without their pad: the
    port runs a short chunk as it is)."""
    return tuple(torch.tensor(a[s:e], device=device) for a in arrays)


def cluster_events(trace: Trace, n_nodes: int, device) -> ClusterEvent:
    """The whole trace as ``[T]`` tensors on ``device``."""
    return ClusterEvent(*_upload(_host_events(trace, n_nodes), 0,
                                 len(trace), device))


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


def _invalidate_nodes(pools: PoolState, mask_n: torch.Tensor, n_nodes: int):
    """Kill every resident of the masked nodes (failure recovery): their
    pools restart empty at their capacity with a reset GreedyDual clock.
    Returns ``(count i32[N] residents killed, cleared pools)``."""
    cnt2 = pools.valid.sum(-1, dtype=torch.int32)                # [2N]
    cnt = torch.where(mask_n, cnt2.view(n_nodes, 2).sum(1, dtype=torch.int32),
                      0)
    m2 = mask_n.unsqueeze(1).expand(n_nodes, 2).reshape(-1)      # [2N]
    col = m2.unsqueeze(1)
    return cnt, pools._replace(
        valid=torch.where(col, False, pools.valid),
        func_id=torch.where(col, -1, pools.func_id),
        free=torch.where(m2, pools.capacity, pools.free),
        clock=torch.where(m2, 0.0, pools.clock))


def _make_step(routing: torch.Tensor, unified: torch.Tensor,
               cloud: torch.Tensor, n_nodes: int, mode: str):
    """Build the per-event step (route, then step the routed pool).
    ``routing`` is the int64[1] routing code, ``unified`` bool[N] and
    ``cloud`` the f32[2] ``(cloud_rtt_s, cloud_cold_prob)``, all on the
    run's device.  ``up_n`` (bool[N], optional) is the live-node mask:
    routing reads it through ``RouteCtx.node_up``, and a request routed
    to a down node drops to the cloud with every pool left as it was."""
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

    def step(pools: PoolState, ev: ClusterEvent, up_n=None):
        tgt = torch.where(unified, 0, ev.cls).to(torch.int64)  # [N] pool
        col = tgt.unsqueeze(1)
        free_t = pools.free.view(n, 2).gather(1, col).squeeze(1)
        cap_t = pools.capacity.view(n, 2).gather(1, col).squeeze(1)
        node = _route(routing, ev, free_t, cap_t, cloud,
                      all_up if up_n is None else xp.asx(up_n), no_slack,
                      no_stage)                               # [1]
        ok = None if up_n is None else up_n.index_select(0, node)  # [1]
        p = node * 2 + tgt.index_select(0, node)              # [1]
        core_ev = Event(ev.t, ev.func_id, ev.size, ev.cls, ev.warm, ev.cold)
        if mode == "gather":
            one = PoolState(*(None if a is None else a.index_select(0, p)
                              for a in pools))
            new_one, outcome = pool_step_batch(one, core_ev, backend)
            for a, b, old in zip(pools, new_one, one):
                if a is not None:
                    if ok is not None:      # a down node's pool is frozen
                        b = torch.where(
                            ok.view((1,) * b.ndim), b, old)
                    a.index_copy_(0, p, b)
        else:
            stepped, outs = pool_step_batch(pools, core_ev, backend)
            sel = pool_ids == p
            if ok is not None:
                sel = sel & ok
            pools = PoolState(*(
                None if a is None else torch.where(
                    sel.view((-1,) + (1,) * (a.ndim - 1)), b, a)
                for a, b in zip(pools, stepped)))
            outcome = outs.index_select(0, p)
        if ok is not None:
            outcome = torch.where(ok, outcome, DROP)
        return pools, node, outcome

    return step


class Pressure(NamedTuple):
    """An autoscaled run's per-event state: the membership ``active``
    bool[N], which is the step's live mask (``up & active`` with
    failures), and the epoch's pressure, ``press`` f32[N, 2] (misses +
    2x drops per routed node and size class) and ``dropw`` f32[1] (the
    drops), to which each event adds in place."""

    active: torch.Tensor
    press: torch.Tensor
    dropw: torch.Tensor


def _add_pressure(acc: Pressure, node, cls, outcome) -> None:
    """Add one event's pressure: 1 for a miss, 2 for a drop, at
    ``(node, cls)``; a drop also adds 1 to ``dropw``.  Whole numbers, so
    the f32 sums are exact in any order."""
    drop = (outcome == DROP).to(torch.float32)                  # [1]
    w = (outcome == MISS).to(torch.float32) + 2.0 * drop
    acc.press.view(-1).index_add_(0, node * 2 + cls, w)
    acc.dropw.add_(drop)


def _run_events(step, pools: PoolState, inval, events: ClusterEvent, up,
                recover, node_out: torch.Tensor, outcome_out: torch.Tensor,
                n_nodes: int, count: int, acc: Pressure | None = None):
    """Events ``[0, count)`` of ``events`` (``[L]`` tensors), one at a
    time, without a host sync.  With failures (``up``/``recover``
    bool[L, N] and ``inval`` i32[N] given) each event first clears the
    nodes recovering at it.  An autoscaled run passes ``acc``: its
    ``active`` mask joins the live mask and each event adds its pressure.
    Writes each event's node and outcome into ``node_out``/``outcome_out``
    and returns ``(pools, inval)``; in ``gather`` mode the static path
    updates ``pools`` in place, else the returned state is new tensors."""
    for i in range(count):
        ev = ClusterEvent(*(a[i] for a in events))
        live = None if up is None else up[i]
        if recover is not None:
            cnt, pools = _invalidate_nodes(pools, recover[i], n_nodes)
            inval = inval + cnt
        if acc is not None:
            live = acc.active if live is None else live & acc.active
        pools, node, outcome = step(pools, ev, live)
        if acc is not None:
            _add_pressure(acc, node, ev.cls, outcome)
        node_out[i:i + 1].copy_(node)
        outcome_out[i:i + 1].copy_(outcome)
    return pools, inval


def _failure_masks(failures: Failures | None, trace: Trace, n_nodes: int):
    """Per-event up/recover bool[T, N] masks: all up and none recovering
    without a schedule."""
    if failures is None:
        t = len(trace)
        return (np.ones((t, n_nodes), bool),
                np.zeros((t, n_nodes), bool))
    return failures.masks(np.asarray(trace.t), n_nodes)


def _run_inputs(cfg: ClusterConfig, device):
    """The run's initial pools and the tensors the step reads: routing
    code int64[1], ``unified`` bool[N] and ``cloud`` f32[2]."""
    return (init_cluster(cfg, device),
            torch.tensor([int(cfg.routing)], dtype=torch.int64,
                         device=device),
            torch.tensor(cfg.unified, dtype=torch.bool, device=device),
            torch.tensor([cfg.cloud_rtt_s, cfg.cloud_cold_prob],
                         dtype=torch.float32, device=device))


def _replay(cfg: ClusterConfig, trace: Trace, device, mode: str,
            chunk: int | None, failures: Failures | None,
            block_events: int | None = None):
    """Run the trace; returns ``(node i32[T], outcome i32[T], invalidated
    i64[N] or None, node_up bool[T, N] or None)`` on the host.

    A monolithic CPU run (``chunk`` None) is the host loop; every other
    run goes chunk by chunk through the block runner (on the card a
    monolithic run is one chunk of the whole trace).  ``block_events``
    overrides :data:`~repro_torch.cluster.graphs.BLOCK_EVENTS`."""
    from . import graphs
    n, t_len = cfg.n_nodes, len(trace)
    failing = failures is not None
    ev_np = _host_events(trace, n)
    masks = _failure_masks(failures, trace, n) if failing else None
    node_np = np.empty(t_len, np.int32)
    outcome_np = np.empty(t_len, np.int32)
    if chunk is None and device.type == "cpu":
        pools, routing, unified, cloud = _run_inputs(cfg, device)
        step = _make_step(routing, unified, cloud, n, mode)
        up, rec = (_upload(masks, 0, t_len, device) if failing
                   else (None, None))
        inval = torch.zeros(n, dtype=torch.int32) if failing else None
        _, inval = _run_events(
            step, pools, inval, ClusterEvent(*_upload(ev_np, 0, t_len,
                                                       device)),
            up, rec, torch.from_numpy(node_np), torch.from_numpy(outcome_np),
            n, t_len)
    else:
        chunk = chunk or max(t_len, 1)
        with sync_point(device):
            runner = graphs.block_runner(device, n, cfg.max_slots, mode,
                                         failing, block_events)
            runner.load(*_run_inputs(cfg, device))
        for s in range(0, t_len, chunk):
            e = min(s + chunk, t_len)
            with sync_point(device):
                ev = ClusterEvent(*_upload(ev_np, s, e, device))
                up, rec = (_upload(masks, s, e, device) if failing
                           else (None, None))
                node = torch.empty(e - s, dtype=torch.int32, device=device)
                outcome = torch.empty_like(node)
            runner.run_chunk(ev, up, rec, node, outcome)
            with sync_point(device):
                node_np[s:e] = node.cpu().numpy()
                outcome_np[s:e] = outcome.cpu().numpy()
        inval = runner.inval if failing else None
    if not failing:
        return node_np, outcome_np, None, None
    with sync_point(device):
        inval = inval.cpu().numpy().astype(np.int64)
    return node_np, outcome_np, inval, masks[0]


def _simulate_cluster(cfg: ClusterConfig, trace: Trace, device,
                      rng_seed: int = 0, mode: str = "gather",
                      chunk_events: int | None = None,
                      failures: Failures | None = None,
                      block_events: int | None = None
                      ) -> tuple[ClusterResult, dict]:
    """One cluster run on ``device`` (``None`` is the CUDA device),
    monolithic or in chunks of ``chunk_events``, with or without
    ``failures``: ``(ClusterResult, extras)``, where ``extras`` is
    ``{"invalidated": i64[N], "node_up": bool[T, N]}`` with failures and
    ``{}`` without."""
    check_step_mode(mode)
    chunk = check_chunk_events(chunk_events)
    device = resolve_device(device)
    node, outcome, inval, up = _replay(cfg, trace, device, mode, chunk,
                                       failures, block_events)
    result = build_result(cfg, trace, node, outcome,
                          cloud_cold_draws(len(trace), cfg.cloud_cold_prob,
                                           rng_seed))
    if failures is None:
        return result, {}
    return result, {"invalidated": inval, "node_up": up}


class AutoscaleInputs(NamedTuple):
    """The per-config tensors an autoscaled run reads beyond the static
    run's: the starting split ``frac0`` f32[N], ``node_mb`` f32[N], the
    f32[5] ``(min_frac, max_frac, gain, spawn_drop_frac,
    retire_drop_frac)`` (+/-inf thresholds when node scaling is off: the
    decision runs the same arithmetic and never fires) and the starting
    membership ``active0`` bool[N]."""

    frac0: torch.Tensor
    node_mb: torch.Tensor
    asc: torch.Tensor
    active0: torch.Tensor


def _autoscale_inputs(cfg: ClusterConfig, asc: Autoscale,
                      device) -> AutoscaleInputs:
    """The reference's ``_autoscale_inputs``, on ``device``."""
    n = cfg.n_nodes
    spawn = asc.spawn_drop_frac if asc.node_scaled else np.inf
    retire = asc.retire_drop_frac if asc.node_scaled else -np.inf
    k = asc.init_active if asc.init_active is not None else n
    f32 = dict(dtype=torch.float32, device=device)
    return AutoscaleInputs(
        torch.tensor(cfg.small_frac, **f32), torch.tensor(cfg.node_mb, **f32),
        torch.tensor([asc.min_frac, asc.max_frac, asc.gain, spawn, retire],
                     **f32),
        torch.tensor(np.arange(n) < k, dtype=torch.bool, device=device))


def _epoch_end(carry, frac: torch.Tensor, inputs: AutoscaleInputs,
               unified: torch.Tensor, now: torch.Tensor,
               n_events: torch.Tensor) -> torch.Tensor:
    """The autoscaler after a full epoch, on the device without a sync.

    Every KiSS node moves its split ``gain * (p_s - p_l) / (p_s + p_l)``
    toward its pressured class, clipped to ``[min_frac, max_frac]``; the
    non-unified pools resize to ``node_mb * frac`` / ``node_mb * (1 -
    frac)`` at ``now`` (the epoch's last event time); then the drop
    fraction ``dropw / n_events`` spawns the first inactive node or
    retires the active node with the fewest MB in use (its residents are
    invalidated), at most one node, never the last.  The reference's f32
    operations in its order, as separate ops.  ``carry`` holds ``pools``,
    ``active``, ``press`` and ``dropw`` and takes the new state with
    ``commit(pools, active, cnt)``.  Returns the new ``frac`` f32[N]."""
    n = frac.shape[0]
    mn, mx, gain, spawn_th, retire_th = inputs.asc.unbind()
    press, active = carry.press, carry.active
    ps, pl = press[:, 0], press[:, 1]
    tot = ps + pl
    some = tot > 0
    delta = torch.where(some, gain * (ps - pl) / torch.where(some, tot, 1.0),
                        0.0)
    cand = torch.minimum(mx, torch.maximum(frac + delta, mn))
    frac = torch.where(unified, frac, cand)
    caps = torch.stack([inputs.node_mb * frac,
                        inputs.node_mb * (1.0 - frac)], 1).reshape(-1)
    pools = carry.pools
    resized = pool_resize(pools, now, caps)
    kiss = ~unified.unsqueeze(1).expand(n, 2).reshape(-1)        # [2N]
    pools = PoolState(*(None if o is None else _select(kiss, r, o)
                        for r, o in zip(resized, pools)))
    drop_frac = carry.dropw[0] / n_events
    n_active = active.sum(dtype=torch.int32)
    can_spawn = (drop_frac > spawn_th) & (n_active < n)
    can_retire = ~can_spawn & (drop_frac < retire_th) & (n_active > 1)
    used_n = (pools.capacity - pools.free).view(n, 2).sum(1)
    ids = torch.arange(n, device=frac.device)
    spawn = ids == _first_true(~active)
    retire = ids == torch.where(active, used_n, float("inf")).argmin()
    new_active = torch.where(can_spawn, active | spawn,
                             torch.where(can_retire, active & ~retire,
                                         active))
    cnt, pools = _invalidate_nodes(pools, retire & can_retire, n)
    carry.commit(pools, new_active, cnt)
    return frac


class _HostCarry:
    """The host loop's carry for the epoch loop, with the block
    runner's interface (``run_chunk``, ``commit``) on tensors that are
    rebound rather than written in place."""

    def __init__(self, step, pools: PoolState, active: torch.Tensor,
                 n_nodes: int):
        self.step, self.pools, self.n_nodes = step, pools, n_nodes
        dev = active.device
        self.active = active
        self.press = torch.zeros((n_nodes, 2), dtype=torch.float32,
                                 device=dev)
        self.dropw = torch.zeros(1, dtype=torch.float32, device=dev)
        self.inval = torch.zeros(n_nodes, dtype=torch.int32, device=dev)

    def run_chunk(self, events, up, recover, node, outcome) -> None:
        self.pools, self.inval = _run_events(
            self.step, self.pools, self.inval, events, up, recover, node,
            outcome, self.n_nodes, node.shape[0],
            Pressure(self.active, self.press, self.dropw))

    def commit(self, pools, active, cnt) -> None:
        self.pools, self.active = pools, active
        self.inval = self.inval + cnt


def _epochs(n_events: int, epoch_events: int) -> list[tuple[int, int]]:
    """``[s, e)`` of each epoch; the last may be partial."""
    return [(s, min(s + epoch_events, n_events))
            for s in range(0, n_events, epoch_events)]


def _replay_autoscale(cfg: ClusterConfig, asc: Autoscale, trace: Trace,
                      device, mode: str, failures: Failures | None,
                      block_events: int | None = None):
    """Run the autoscaled trace; returns ``(node i32[T], outcome i32[T],
    fracs f32[E, N], active bool[E, N], invalidated i64[N], node_up
    bool[T, N] or None)`` on the host.

    A CPU run without ``block_events`` is the host loop; every other run
    steps each epoch as one chunk of the block runner (on the card, each
    block of ``BLOCK_EVENTS`` events one graph replay).  The whole trace
    is uploaded once; between epochs nothing is read back."""
    from . import graphs
    n, t_len = cfg.n_nodes, len(trace)
    failing = failures is not None
    masks = _failure_masks(failures, trace, n) if failing else None
    spans = _epochs(t_len, asc.epoch_events)
    with sync_point(device):
        pools, routing, unified, cloud = _run_inputs(cfg, device)
        inputs = _autoscale_inputs(cfg, asc, device)
        ev = ClusterEvent(*_upload(_host_events(trace, n), 0, t_len, device))
        up, rec = (_upload(masks, 0, t_len, device) if failing
                   else (None, None))
        node = torch.empty(t_len, dtype=torch.int32, device=device)
        outcome = torch.empty_like(node)
        fracs = torch.empty((len(spans), n), dtype=torch.float32,
                            device=device)
        actives = torch.empty((len(spans), n), dtype=torch.bool,
                              device=device)
        n_full = torch.full((), float(asc.epoch_events),
                            dtype=torch.float32, device=device)
        if device.type == "cpu" and block_events is None:
            carry = _HostCarry(
                _make_step(routing, unified, cloud, n, mode), pools,
                inputs.active0, n)
        else:
            carry = graphs.block_runner(device, n, cfg.max_slots, mode,
                                        failing, block_events,
                                        autoscaled=True)
            carry.load(pools, routing, unified, cloud, inputs.active0)
    frac = inputs.frac0
    for k, (s, e) in enumerate(spans):
        carry.press.zero_()
        carry.dropw.zero_()
        carry.run_chunk(ClusterEvent(*(a[s:e] for a in ev)),
                        None if up is None else up[s:e],
                        None if rec is None else rec[s:e],
                        node[s:e], outcome[s:e])
        if e - s == asc.epoch_events:
            frac = _epoch_end(carry, frac, inputs, unified,
                              ev.t[s:e].amax(), n_full)
        fracs[k].copy_(frac)
        actives[k].copy_(carry.active)
    with sync_point(device):
        out = (node.cpu().numpy(), outcome.cpu().numpy(),
               fracs.cpu().numpy(), actives.cpu().numpy(),
               carry.inval.cpu().numpy().astype(np.int64))
    return out + (masks[0] if failing else None,)


def _autoscale_extras(actives, inval, up, failures) -> dict:
    return {"invalidated": np.asarray(inval, np.int64),
            "node_up": up if failures is not None else None,
            "active": np.asarray(actives, bool)}


def _simulate_cluster_autoscale(cfg: ClusterConfig, asc: Autoscale,
                                trace: Trace, device, rng_seed: int = 0,
                                mode: str = "gather",
                                failures: Failures | None = None,
                                block_events: int | None = None):
    """One autoscaled run on ``device`` (``None`` is the CUDA device),
    with or without ``failures``: ``(ClusterResult, fracs f32[E, N],
    extras)``, where ``extras`` holds the membership trajectory
    ``active`` bool[E, N], ``invalidated`` i64[N] (recoveries and
    retirements) and ``node_up`` (``None`` without failures).
    ``block_events`` sends a CPU run through the block runner with that
    block length (on the card it overrides ``BLOCK_EVENTS``)."""
    check_step_mode(mode)
    device = resolve_device(device)
    node, outcome, fracs, actives, inval, up = _replay_autoscale(
        cfg, asc, trace, device, mode, failures, block_events)
    result = build_result(cfg, trace, node, outcome,
                          cloud_cold_draws(len(trace), cfg.cloud_cold_prob,
                                           rng_seed))
    return result, fracs, _autoscale_extras(actives, inval, up, failures)


# The reference's four entry points, with its return shapes.

def _simulate_cluster_torch(cfg, trace, device, rng_seed=0,
                            mode="gather") -> ClusterResult:
    return _simulate_cluster(cfg, trace, device, rng_seed, mode)[0]


def _simulate_cluster_failures_torch(cfg, failures, trace, device,
                                     rng_seed=0, mode="gather"):
    return _simulate_cluster(cfg, trace, device, rng_seed, mode,
                             failures=failures)


def _simulate_cluster_chunked_torch(cfg, trace, device, rng_seed=0,
                                    mode="gather", chunk_events=65536,
                                    failures=None, block_events=None):
    result, extras = _simulate_cluster(cfg, trace, device, rng_seed, mode,
                                       chunk_events, failures, block_events)
    return result if failures is None else (result, extras)


def _simulate_cluster_autoscale_torch(cfg, asc, trace, device, rng_seed=0,
                                      mode="gather", failures=None):
    return _simulate_cluster_autoscale(cfg, asc, trace, device, rng_seed,
                                       mode, failures)
