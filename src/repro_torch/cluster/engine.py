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

Telemetry (``window`` events a window) and chains (a
:class:`~repro_torch.core.continuum.ChainPlan`) ride every run shape.
With chains on, each event reads its chain's latency so far and its
deadline (``_chain_pre``: the slack and stage routing sees), and after
its step adds the stage's latency and its drop to the chain's row and
judges the deadline at the chain's final stage (``_chain_event``); the
per-chain latency f32[C] and drop flag bool[C] are device state written
in place, the miss flag is a per-event output.  Telemetry needs from the
device only what the host cannot derive: the state after each window's
last event (free MB and residents per node, :class:`TelSink`) and each
event's recovery invalidations; the counters, up and active counts and
window sums are folded on the host from the per-event outputs
(:func:`_tel_np`), exact integers in any order.  Window indices and
chain rows are global, so a chunked run gives the monolithic arrays for
any chunk size.

Vertical scaling (``ClusterConfig.resize_policy``) rides every run shape
too: the events carry each one's observed usage ``used`` (computed on
the host by ``observed_usage`` with numpy, uploaded with the other
columns), every pool carries the resize fields, a recovery or a
retirement zeroes the limits and usage of the node's residents and keeps
the run totals, and the final state's totals come back as the run's
``vertical`` arrays (:func:`_vert_np`).

Not ported yet: sweeps (ROADMAP A12).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device, sync_point
from ..core import xp
from ..core.continuum import (Autoscale, ChainPlan, ClusterConfig, Failures,
                              cloud_cold_draws, route_hashes)
from ..core.pool import (Event, PoolState, _evict_place_lax, _first_true,
                         _select, get_step_backend, init_pool, pool_resize,
                         pool_step_batch, stack_pools)
from ..core.registry import ROUTING, RouteCtx, observed_usage
from ..core.types import DROP, HIT, MISS, PoolConfig, Trace
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
    a whole trace of them (``[T]`` arrays).  ``used`` is the observed
    usage a cold start records (resize only; ``None`` otherwise)."""

    t: torch.Tensor
    func_id: torch.Tensor
    size: torch.Tensor
    cls: torch.Tensor
    warm: torch.Tensor
    cold: torch.Tensor
    h1: torch.Tensor     # sticky hash: func_id % n_nodes
    h2: torch.Tensor     # second (Knuth multiplicative) hash
    used: torch.Tensor | None = None   # f32 observed usage (resize only)


def _host_events(trace: Trace, n_nodes: int, *,
                 resize: bool = False) -> ClusterEvent:
    """The trace as ``[T]`` numpy columns with the reference's dtypes
    (f32 times and sizes, i32 ids, classes and hashes, and with
    ``resize`` the f32 observed usage); a chunked run uploads one slice
    of them at a time."""
    h1, h2 = route_hashes(trace.func_id, n_nodes)
    fid = np.asarray(trace.func_id, np.int32)
    size = np.asarray(trace.size_mb, np.float32)
    return ClusterEvent(
        t=np.asarray(trace.t, np.float32),
        func_id=fid,
        size=size,
        cls=np.asarray(trace.cls, np.int32),
        warm=np.asarray(trace.warm_dur, np.float32),
        cold=np.asarray(trace.cold_dur, np.float32),
        h1=h1, h2=h2,
        used=observed_usage(np, fid, size) if resize else None)


def _upload(arrays, s: int, e: int, device) -> tuple:
    """Events ``[s, e)`` of host arrays as tensors on ``device`` (the
    reference's ``_chunk_slice``/``_chunk_mask``, without their pad: the
    port runs a short chunk as it is); a ``None`` column stays ``None``."""
    return tuple(None if a is None else torch.tensor(a[s:e], device=device)
                 for a in arrays)


def _each(events: ClusterEvent, f) -> ClusterEvent:
    """``f`` applied to every column of ``events`` (an index or a
    slice), a ``None`` column passed through."""
    return ClusterEvent(*(None if a is None else f(a) for a in events))


def cluster_events(trace: Trace, n_nodes: int, device, *,
                   resize: bool = False) -> ClusterEvent:
    """The whole trace as ``[T]`` tensors on ``device``."""
    return ClusterEvent(*_upload(_host_events(trace, n_nodes,
                                              resize=resize), 0,
                                 len(trace), device))


def init_cluster(cfg: ClusterConfig, device) -> PoolState:
    """Stack all 2N pools of the cluster on a leading axis."""
    caps = cfg.pool_caps()
    return stack_pools([
        init_pool(PoolConfig(caps[n, k], cfg.policy, cfg.max_slots,
                             resize_policy=cfg.resize_policy,
                             resize_min_mb=cfg.resize_min_mb), device)
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
    """Kill every resident of the masked nodes (failure recovery, node
    retirement): their pools restart empty at their capacity with a
    reset GreedyDual clock; with resize on, the residents' limits and
    usage die with them and the run totals stay.  Returns ``(count
    i32[N] residents killed, cleared pools)``."""
    cnt2 = pools.valid.sum(-1, dtype=torch.int32)                # [2N]
    cnt = torch.where(mask_n, cnt2.view(n_nodes, 2).sum(1, dtype=torch.int32),
                      0)
    m2 = mask_n.unsqueeze(1).expand(n_nodes, 2).reshape(-1)      # [2N]
    col = m2.unsqueeze(1)
    extra = {}
    if pools.alloc is not None:
        extra = dict(alloc=torch.where(col, 0.0, pools.alloc),
                     used=torch.where(col, 0.0, pools.used))
    return cnt, pools._replace(
        valid=torch.where(col, False, pools.valid),
        func_id=torch.where(col, -1, pools.func_id),
        free=torch.where(m2, pools.capacity, pools.free),
        clock=torch.where(m2, 0.0, pools.clock), **extra)


def _make_step(routing: torch.Tensor, unified: torch.Tensor,
               cloud: torch.Tensor, n_nodes: int, mode: str):
    """Build the per-event step (route, then step the routed pool).
    ``routing`` is the int64[1] routing code, ``unified`` bool[N] and
    ``cloud`` the f32[2] ``(cloud_rtt_s, cloud_cold_prob)``, all on the
    run's device.  ``up_n`` (bool[N], optional) is the live-node mask:
    routing reads it through ``RouteCtx.node_up``, and a request routed
    to a down node drops to the cloud with every pool left as it was.
    ``cslack``/``cstage`` (0-d f32/i32, optional) are the event's chain
    slack and stage for ``RouteCtx``; without them the step reads the
    constants ``+inf``/``-1``, so slack-aware policies take their
    slack-rich branch."""
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

    def step(pools: PoolState, ev: ClusterEvent, up_n=None, cslack=None,
             cstage=None):
        tgt = torch.where(unified, 0, ev.cls).to(torch.int64)  # [N] pool
        col = tgt.unsqueeze(1)
        free_t = pools.free.view(n, 2).gather(1, col).squeeze(1)
        cap_t = pools.capacity.view(n, 2).gather(1, col).squeeze(1)
        node = _route(routing, ev, free_t, cap_t, cloud,
                      all_up if up_n is None else xp.asx(up_n),
                      no_slack if cslack is None else cslack,
                      no_stage if cstage is None else cstage)  # [1]
        ok = None if up_n is None else up_n.index_select(0, node)  # [1]
        p = node * 2 + tgt.index_select(0, node)              # [1]
        core_ev = Event(ev.t, ev.func_id, ev.size, ev.cls, ev.warm, ev.cold,
                        ev.used)
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


class ChainXs(NamedTuple):
    """Per-event chain data (``[L]`` tensors): the dense chain row
    (int64, an ``index_select`` index), the stage (i32), whether the
    event is its chain's final stage, and the pre-drawn cloud cold flip
    that prices a dropped stage."""

    cid: torch.Tensor
    stage: torch.Tensor
    last: torch.Tensor
    ccold: torch.Tensor


class ChainAcc(NamedTuple):
    """A run's chain state on its device: the latency so far ``lat``
    f32[C] and ``dropped`` bool[C], which each event of a chain writes in
    its row in place, and what the step reads: ``deadline`` f32[C] and
    the cloud round trip ``rtt`` (0-d f32) that a drop pays."""

    lat: torch.Tensor
    dropped: torch.Tensor
    deadline: torch.Tensor
    rtt: torch.Tensor


def _chain_xs_np(plan: ChainPlan, ccold: np.ndarray) -> ChainXs:
    """The plan's per-event arrays on the host, in the dtypes the step
    reads; a run uploads them a chunk at a time."""
    return ChainXs(cid=np.asarray(plan.cid, np.int64),
                   stage=np.asarray(plan.stage, np.int32),
                   last=np.asarray(plan.last, bool),
                   ccold=np.asarray(ccold, bool))


def _chain_acc(deadline: torch.Tensor, cloud: torch.Tensor) -> ChainAcc:
    """Zeroed chain state for the deadlines f32[C], on their device."""
    return ChainAcc(lat=torch.zeros_like(deadline),
                    dropped=torch.zeros_like(deadline, dtype=torch.bool),
                    deadline=deadline, rtt=cloud[0])


def _chain_pre(acc: ChainAcc, c: torch.Tensor):
    """The event's chain view before its step (the reference's
    ``_chain_pre``): the chain's latency so far and deadline, both [1],
    and the slack ``deadline - latency`` as the 0-d value routing reads.
    ``c`` is the chain row as an int64[1] tensor."""
    lat = acc.lat.index_select(0, c)
    dl = acc.deadline.index_select(0, c)
    return lat, dl, (dl - lat).view(())


def _chain_event(acc: ChainAcc, c: torch.Tensor, last, ccold, lat, dl,
                 ev: ClusterEvent, outcome: torch.Tensor) -> torch.Tensor:
    """Fold one stepped event into its chain's row, in place (the
    reference's ``_chain_event``, its f32 operations in its order): price
    the stage (hit -> warm, miss -> cold, drop -> RTT + cold or warm by
    the pre-drawn flip), add it to the latency, note a drop, and judge
    the deadline if this is the final stage (a dropped stage misses
    whatever the time).  Returns the miss flag bool[1]."""
    stage_lat = torch.where(
        outcome == HIT, ev.warm,
        torch.where(outcome == MISS, ev.cold,
                    acc.rtt + torch.where(ccold, ev.cold, ev.warm)))
    final = lat + stage_lat
    dropped = acc.dropped.index_select(0, c) | (outcome == DROP)
    acc.lat.index_copy_(0, c, final)
    acc.dropped.index_copy_(0, c, dropped)
    return last & (dropped | (final > dl))


def _n_windows(n_events: int, window: int) -> int:
    return -(-n_events // window)


def _snapshot(pools: PoolState, n_nodes: int, free_out: torch.Tensor,
              occ_out: torch.Tensor) -> None:
    """Write the state after an event into ``free_out`` f32[N] (free MB
    per node, ``free.view(N, 2).sum(1)`` as the reference sums it) and
    ``occ_out`` i32[N] (resident containers per node), in place."""
    torch.sum(pools.free.reshape(n_nodes, 2), 1, out=free_out)
    torch.sum(pools.valid.reshape(n_nodes, -1), 1, dtype=torch.int32,
              out=occ_out)


class TelSink:
    """The telemetry a run keeps on its device: the state after each
    window's last event, free MB ``free`` f32[W, N] and residents
    ``occ`` i32[W, N] (the reference's snapshot columns, last write
    wins).  Window ``w`` holds global events ``[w * window, (w + 1) *
    window)``; the last window may be short."""

    def __init__(self, window: int, n_events: int, n_nodes: int, device):
        w = _n_windows(n_events, window)
        self.window, self.n_events, self.n_nodes = window, n_events, n_nodes
        self.free = torch.zeros((w, n_nodes), dtype=torch.float32,
                                device=device)
        self.occ = torch.zeros((w, n_nodes), dtype=torch.int32,
                               device=device)

    def is_end(self, j: int) -> bool:
        """Whether global event ``j`` is its window's last."""
        return (j + 1) % self.window == 0 or j == self.n_events - 1

    def ends(self, s: int, e: int) -> list[int]:
        """The global events in ``[s, e)`` that end a window."""
        out = list(range(s + (self.window - 1 - s) % self.window, e,
                         self.window))
        last = self.n_events - 1
        if s <= last < e and (last + 1) % self.window:
            out.append(last)
        return out

    def at_ends(self, base: int):
        """The snapshot function of an eagerly stepped span whose first
        event is global event ``base``: event ``i`` of the span writes
        its window's row if it ends the window."""
        def snap(i: int, pools: PoolState) -> None:
            j = base + i
            if self.is_end(j):
                w = j // self.window
                _snapshot(pools, self.n_nodes, self.free[w], self.occ[w])
        return snap


class EventOut(NamedTuple):
    """Per-event outputs beyond node and outcome (``[L]`` tensors, or
    ``None`` when the run keeps no such thing): the residents a
    recovery invalidated at the event (telemetry with failures), the
    chain deadline miss (chains), and ``snap(i, pools)``, which records
    the state after event ``i`` (telemetry)."""

    inval: torch.Tensor | None = None
    miss: torch.Tensor | None = None
    snap: object = None


def _run_events(step, pools: PoolState, inval, events: ClusterEvent, up,
                recover, node_out: torch.Tensor, outcome_out: torch.Tensor,
                n_nodes: int, count: int, acc: Pressure | None = None,
                chain: tuple | None = None, out: EventOut | None = None):
    """Events ``[0, count)`` of ``events`` (``[L]`` tensors), one at a
    time, without a host sync.  With failures (``up``/``recover``
    bool[L, N] and ``inval`` i32[N] given) each event first clears the
    nodes recovering at it.  An autoscaled run passes ``acc``: its
    ``active`` mask joins the live mask and each event adds its pressure.
    ``chain`` is ``(ChainAcc, ChainXs)`` with chains on: each event
    routes with its chain's slack and stage and is folded into its
    chain's row.  ``out`` takes the per-event telemetry and chain
    outputs.  Writes each event's node and outcome into
    ``node_out``/``outcome_out`` and returns ``(pools, inval)``; in
    ``gather`` mode the static path updates ``pools`` in place, else the
    returned state is new tensors."""
    out = out or EventOut()
    for i in range(count):
        ev = _each(events, lambda a: a[i])
        live = None if up is None else up[i]
        if recover is not None:
            cnt, pools = _invalidate_nodes(pools, recover[i], n_nodes)
            inval = inval + cnt
            if out.inval is not None:
                out.inval[i:i + 1].copy_(cnt.sum(dtype=torch.int32))
        if acc is not None:
            live = acc.active if live is None else live & acc.active
        if chain is None:
            pools, node, outcome = step(pools, ev, live)
        else:
            cacc, cx = chain
            c = cx.cid[i:i + 1]
            lat, dl, slack = _chain_pre(cacc, c)
            pools, node, outcome = step(pools, ev, live, slack, cx.stage[i])
            out.miss[i:i + 1].copy_(_chain_event(
                cacc, c, cx.last[i], cx.ccold[i], lat, dl, ev, outcome))
        if acc is not None:
            _add_pressure(acc, node, ev.cls, outcome)
        if out.snap is not None:
            out.snap(i, pools)
        node_out[i:i + 1].copy_(node)
        outcome_out[i:i + 1].copy_(outcome)
    return pools, inval


def _tel_np(sink: TelSink, cls: np.ndarray, outcome: np.ndarray,
            inval_ev: np.ndarray | None = None,
            miss_ev: np.ndarray | None = None, up: np.ndarray | None = None,
            active: np.ndarray | None = None, retired=()) -> dict:
    """The window arrays under the reference's ``_tel_np`` keys.  Counters
    are integer sums of the per-event outputs (exact in any order): the
    counts per (class, outcome), the recovery invalidations ``inval_ev``
    i32[T] plus each retirement ``(e, count)`` in the window of its
    epoch's last event ``e - 1``, and the chain misses ``miss_ev``.  The
    up and active node counts are those of each window's last event
    (``up`` bool[T, N] and ``active`` i64[T] counts; all N without
    them); the snapshots are the sink's.  Reads the sink back: call it
    inside a sync point."""
    t, window, n = len(outcome), sink.window, sink.n_nodes
    w_of = np.arange(t) // window
    n_w = _n_windows(t, window)
    ends = np.minimum((np.arange(n_w) + 1) * window, t) - 1
    counts = np.zeros((n_w, 2, 3), np.int64)
    np.add.at(counts, (w_of, np.asarray(cls), np.asarray(outcome)), 1)
    inval = np.zeros(n_w, np.int64)
    if inval_ev is not None:
        np.add.at(inval, w_of, inval_ev)
    for e, cnt in retired:
        inval[(e - 1) // window] += cnt
    cmiss = np.zeros(n_w, np.int64)
    if miss_ev is not None:
        np.add.at(cmiss, w_of, miss_ev)
    return {
        "counts": counts,
        "free_mb": sink.free.cpu().numpy(),
        "occupancy": sink.occ.cpu().numpy().astype(np.int64),
        "invalidated": inval,
        "nodes_up": (np.full(n_w, n, np.int64) if up is None
                     else up[ends].sum(1).astype(np.int64)),
        "nodes_active": (np.full(n_w, n, np.int64) if active is None
                         else np.asarray(active, np.int64)[ends]),
        "chain_miss": cmiss}


def _chain_np(plan: ChainPlan, chain: ChainAcc, miss_ev: np.ndarray) -> dict:
    """The per-chain arrays under the reference's ``_chain_np`` keys:
    latency and drops from the device state, ``done`` (a final stage was
    stepped) from the plan and ``missed`` from the per-event miss flags,
    both the OR over the chain's events the reference accumulates.
    Copies the state (a runner's is reused by its next run, and on the
    CPU ``.cpu().numpy()`` would share its storage); call it inside a
    sync point."""
    c = plan.n_chains
    done = np.zeros(c, bool)
    done[plan.cid[plan.last]] = True
    missed = np.zeros(c, bool)
    missed[plan.cid[np.asarray(miss_ev) != 0]] = True
    return {"latency": chain.lat[:c].cpu().numpy().copy(),
            "dropped": chain.dropped[:c].cpu().numpy().copy(),
            "done": done, "missed": missed}


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


class _RunData(NamedTuple):
    """What a run uploads beyond the events: the failure masks
    (``masks`` ``(up, recover)`` bool[T, N] or ``None``), the chain
    plan's per-event arrays (``cx`` or ``None``) and the chain
    deadlines f32[C] on the device (or ``None``), all on the host but
    the deadlines."""

    masks: tuple | None
    cx: ChainXs | None
    deadline: torch.Tensor | None


def _run_data(trace: Trace, n_nodes: int, failures, plan, ccold, device):
    masks = (_failure_masks(failures, trace, n_nodes)
             if failures is not None else None)
    if plan is None:
        return _RunData(masks, None, None)
    return _RunData(masks, _chain_xs_np(plan, ccold),
                    torch.tensor(plan.deadline[:plan.n_chains],
                                 dtype=torch.float32, device=device))


def _outputs(t_len: int, failing: bool, tel_on: bool, ch_on: bool,
             device) -> tuple:
    """A run's per-event output tensors: node and outcome, and the
    recovery invalidations (telemetry with failures) and the chain miss
    flags (chains), each i32[T] or ``None``."""
    def i32():
        return torch.zeros(t_len, dtype=torch.int32, device=device)
    return (i32(), i32(), i32() if failing and tel_on else None,
            i32() if ch_on else None)


def _vert_np(pools: PoolState) -> dict:
    """The vertical-scaling run totals of a final pool state on the host,
    per pool in the stacked node-major ``[2N]`` layout, under the
    reference's ``_vert_np`` keys (copies: a runner's state is reused by
    its next run).  Reads the device back: call it inside a sync
    point."""
    return {"acc_used_mb": pools.acc_used.cpu().numpy().copy(),
            "acc_alloc_mb": pools.acc_alloc.cpu().numpy().copy(),
            "bottlenecks": pools.bneck.cpu().numpy().astype(np.int64)}


def _extras(trace: Trace, outcome, data: _RunData, window, plan, sink,
            chain, inval_ev, miss_ev, pools: PoolState, active=None,
            retired=()) -> dict:
    """The run's telemetry, chain and vertical-scaling arrays
    (``"telemetry"``, ``"chains"``, ``"vertical"``) from its per-event
    outputs and device state, the final ``pools`` among it.  Reads the
    device back: call it inside a sync point."""
    out = {}
    if window is not None:
        out["telemetry"] = _tel_np(
            sink, trace.cls, outcome,
            None if inval_ev is None else inval_ev.cpu().numpy(),
            None if miss_ev is None else miss_ev.cpu().numpy(),
            None if data.masks is None else data.masks[0], active, retired)
    if plan is not None:
        out["chains"] = _chain_np(plan, chain, miss_ev.cpu().numpy())
    if pools.alloc is not None:
        out["vertical"] = _vert_np(pools)
    return out


def _replay(cfg: ClusterConfig, trace: Trace, device, mode: str,
            chunk: int | None, failures: Failures | None,
            block_events: int | None = None, window: int | None = None,
            plan: ChainPlan | None = None, ccold: np.ndarray | None = None):
    """Run the trace; returns ``(node i32[T], outcome i32[T], extras)``
    on the host, ``extras`` holding ``invalidated`` i64[N] and
    ``node_up`` bool[T, N] with failures, ``telemetry`` with a window
    length ``window`` and ``chains`` with a chain ``plan`` (whose cloud
    cold flips are ``ccold`` bool[T]).

    A monolithic CPU run (``chunk`` None) is the host loop; every other
    run goes chunk by chunk through the block runner (on the card a
    monolithic run is one chunk of the whole trace).  ``block_events``
    overrides :data:`~repro_torch.cluster.graphs.BLOCK_EVENTS`."""
    from . import graphs
    n, t_len = cfg.n_nodes, len(trace)
    failing = failures is not None
    tel_on, ch_on = window is not None, plan is not None
    rz_on = cfg.resize_policy is not None
    ev_np = _host_events(trace, n, resize=rz_on)
    with sync_point(device):
        data = _run_data(trace, n, failures, plan, ccold, device)
        sink = TelSink(window, t_len, n, device) if tel_on else None
    if chunk is None and device.type == "cpu":
        pools, routing, unified, cloud = _run_inputs(cfg, device)
        step = _make_step(routing, unified, cloud, n, mode)
        up, rec = (_upload(data.masks, 0, t_len, device) if failing
                   else (None, None))
        inval = torch.zeros(n, dtype=torch.int32) if failing else None
        node, outcome, inval_ev, miss_ev = _outputs(t_len, failing, tel_on,
                                                    ch_on, device)
        chain = _chain_acc(data.deadline, cloud) if ch_on else None
        pools, inval = _run_events(
            step, pools, inval, ClusterEvent(*_upload(ev_np, 0, t_len,
                                                       device)),
            up, rec, node, outcome, n, t_len,
            chain=None if chain is None else (
                chain, ChainXs(*_upload(data.cx, 0, t_len, device))),
            out=EventOut(inval_ev, miss_ev,
                         None if sink is None else sink.at_ends(0)))
    else:
        chunk = chunk or max(t_len, 1)
        with sync_point(device):
            runner = graphs.block_runner(
                device, n, cfg.max_slots, mode, failing, block_events,
                tel=tel_on, chains=plan.n_chains if ch_on else 0,
                resize=rz_on)
            runner.load(*_run_inputs(cfg, device), deadline=data.deadline,
                        sink=sink)
            host = _outputs(t_len, failing, tel_on, ch_on, "cpu")
        for s in range(0, t_len, chunk):
            e = min(s + chunk, t_len)
            with sync_point(device):
                ev = ClusterEvent(*_upload(ev_np, s, e, device))
                up, rec = (_upload(data.masks, s, e, device) if failing
                           else (None, None))
                cx = (ChainXs(*_upload(data.cx, s, e, device)) if ch_on
                      else None)
                outs = _outputs(e - s, failing, tel_on, ch_on, device)
            runner.run_chunk(ev, up, rec, outs[0], outs[1], s, cx, *outs[2:])
            with sync_point(device):
                for h, d in zip(host, outs):
                    if h is not None:
                        h[s:e].copy_(d)
        node, outcome, inval_ev, miss_ev = host
        inval, chain, pools = runner.inval, runner.chain, runner.pools
    node_np, outcome_np = node.numpy(), outcome.numpy()
    with sync_point(device):
        extras = _extras(trace, outcome_np, data, window, plan, sink, chain,
                         inval_ev, miss_ev, pools)
        if failing:
            extras.update(invalidated=inval.cpu().numpy().astype(np.int64),
                          node_up=data.masks[0])
    return node_np, outcome_np, extras


def _simulate_cluster(cfg: ClusterConfig, trace: Trace, device,
                      rng_seed: int = 0, mode: str = "gather",
                      chunk_events: int | None = None,
                      failures: Failures | None = None,
                      block_events: int | None = None,
                      telemetry: int | None = None,
                      chains: ChainPlan | None = None
                      ) -> tuple[ClusterResult, dict]:
    """One cluster run on ``device`` (``None`` is the CUDA device),
    monolithic or in chunks of ``chunk_events``, with or without
    ``failures``: ``(ClusterResult, extras)``, where ``extras`` holds
    ``invalidated`` i64[N] and ``node_up`` bool[T, N] with failures, the
    window arrays ``telemetry`` with a window length ``telemetry``, and
    the per-chain arrays ``chains`` with a compiled chain plan
    ``chains`` (the reference's ``_tel_np``/``_chain_np`` keys)."""
    check_step_mode(mode)
    chunk = check_chunk_events(chunk_events)
    device = resolve_device(device)
    ccold = cloud_cold_draws(len(trace), cfg.cloud_cold_prob, rng_seed)
    node, outcome, extras = _replay(cfg, trace, device, mode, chunk,
                                    failures, block_events, telemetry,
                                    chains, ccold)
    return build_result(cfg, trace, node, outcome, ccold), extras


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
    rebound rather than written in place.  ``chain`` (a
    :class:`ChainAcc`) and ``sink`` (a :class:`TelSink`) are the run's,
    when chains and telemetry are on."""

    def __init__(self, step, pools: PoolState, active: torch.Tensor,
                 n_nodes: int, chain: ChainAcc | None = None,
                 sink: TelSink | None = None):
        self.step, self.pools, self.n_nodes = step, pools, n_nodes
        self.chain, self.sink = chain, sink
        dev = active.device
        self.active = active
        self.press = torch.zeros((n_nodes, 2), dtype=torch.float32,
                                 device=dev)
        self.dropw = torch.zeros(1, dtype=torch.float32, device=dev)
        self.inval = torch.zeros(n_nodes, dtype=torch.int32, device=dev)

    def run_chunk(self, events, up, recover, node, outcome, base=0,
                  cx=None, inval=None, miss=None) -> None:
        self.pools, self.inval = _run_events(
            self.step, self.pools, self.inval, events, up, recover, node,
            outcome, self.n_nodes, node.shape[0],
            Pressure(self.active, self.press, self.dropw),
            None if cx is None else (self.chain, cx),
            EventOut(inval, miss,
                     None if self.sink is None else self.sink.at_ends(base)))

    def commit(self, pools, active, cnt) -> None:
        self.pools, self.active = pools, active
        self.inval = self.inval + cnt


def _epochs(n_events: int, epoch_events: int) -> list[tuple[int, int]]:
    """``[s, e)`` of each epoch; the last may be partial."""
    return [(s, min(s + epoch_events, n_events))
            for s in range(0, n_events, epoch_events)]


def _replay_autoscale(cfg: ClusterConfig, asc: Autoscale, trace: Trace,
                      device, mode: str, failures: Failures | None,
                      block_events: int | None = None,
                      window: int | None = None,
                      plan: ChainPlan | None = None,
                      ccold: np.ndarray | None = None):
    """Run the autoscaled trace; returns ``(node i32[T], outcome i32[T],
    fracs f32[E, N], extras)`` on the host, ``extras`` holding the
    membership ``active`` bool[E, N], ``invalidated`` i64[N],
    ``node_up`` (bool[T, N] or ``None``) and, when on, ``telemetry``
    (retirements in the window of their epoch's last event) and
    ``chains``.

    A CPU run without ``block_events`` is the host loop; every other run
    steps each epoch as one chunk of the block runner (on the card, each
    block of ``BLOCK_EVENTS`` events one graph replay).  The whole trace
    is uploaded once; between epochs nothing is read back."""
    from . import graphs
    n, t_len = cfg.n_nodes, len(trace)
    failing = failures is not None
    tel_on, ch_on = window is not None, plan is not None
    rz_on = cfg.resize_policy is not None
    spans = _epochs(t_len, asc.epoch_events)
    with sync_point(device):
        data = _run_data(trace, n, failures, plan, ccold, device)
        sink = TelSink(window, t_len, n, device) if tel_on else None
        pools, routing, unified, cloud = _run_inputs(cfg, device)
        inputs = _autoscale_inputs(cfg, asc, device)
        ev = cluster_events(trace, n, device, resize=rz_on)
        up, rec = (_upload(data.masks, 0, t_len, device) if failing
                   else (None, None))
        cx = ChainXs(*_upload(data.cx, 0, t_len, device)) if ch_on else None
        node, outcome, inval_ev, miss_ev = _outputs(t_len, failing, tel_on,
                                                    ch_on, device)
        fracs = torch.empty((len(spans), n), dtype=torch.float32,
                            device=device)
        actives = torch.empty((len(spans), n), dtype=torch.bool,
                              device=device)
        retired = torch.zeros(len(spans), dtype=torch.int32, device=device)
        n_full = torch.full((), float(asc.epoch_events),
                            dtype=torch.float32, device=device)
        if device.type == "cpu" and block_events is None:
            carry = _HostCarry(
                _make_step(routing, unified, cloud, n, mode), pools,
                inputs.active0, n,
                _chain_acc(data.deadline, cloud) if ch_on else None, sink)
        else:
            carry = graphs.block_runner(
                device, n, cfg.max_slots, mode, failing, block_events,
                autoscaled=True, tel=tel_on,
                chains=plan.n_chains if ch_on else 0, resize=rz_on)
            carry.load(pools, routing, unified, cloud, inputs.active0,
                       data.deadline, sink)
    frac = inputs.frac0

    def cut(a, s, e):
        return None if a is None else a[s:e]
    for k, (s, e) in enumerate(spans):
        carry.press.zero_()
        carry.dropw.zero_()
        carry.run_chunk(_each(ev, lambda a: a[s:e]), cut(up, s, e),
                        cut(rec, s, e), node[s:e], outcome[s:e], s,
                        None if cx is None else ChainXs(*(a[s:e] for a in cx)),
                        cut(inval_ev, s, e), cut(miss_ev, s, e))
        if e - s == asc.epoch_events:
            if tel_on:
                before = carry.inval.sum(dtype=torch.int32)
            frac = _epoch_end(carry, frac, inputs, unified,
                              ev.t[s:e].amax(), n_full)
            if tel_on:
                retired[k:k + 1].copy_(
                    carry.inval.sum(dtype=torch.int32) - before)
        fracs[k].copy_(frac)
        actives[k].copy_(carry.active)
    with sync_point(device):
        outcome_np, actives_np = outcome.cpu().numpy(), actives.cpu().numpy()
        active_ev = None
        if tel_on:
            rows = np.concatenate([inputs.active0.cpu().numpy()[None],
                                   actives_np[:-1]]).sum(1)
            active_ev = np.repeat(rows, asc.epoch_events)[:t_len]
        extras = _extras(trace, outcome_np, data, window, plan, sink,
                         carry.chain, inval_ev, miss_ev, carry.pools,
                         active_ev,
                         [(e, int(c)) for (_, e), c in
                          zip(spans, retired.cpu().numpy()) if c])
        extras.update(
            invalidated=carry.inval.cpu().numpy().astype(np.int64),
            node_up=data.masks[0] if failing else None, active=actives_np)
        return (node.cpu().numpy(), outcome_np, fracs.cpu().numpy(),
                extras)


def _simulate_cluster_autoscale(cfg: ClusterConfig, asc: Autoscale,
                                trace: Trace, device, rng_seed: int = 0,
                                mode: str = "gather",
                                failures: Failures | None = None,
                                block_events: int | None = None,
                                telemetry: int | None = None,
                                chains: ChainPlan | None = None):
    """One autoscaled run on ``device`` (``None`` is the CUDA device),
    with or without ``failures``: ``(ClusterResult, fracs f32[E, N],
    extras)``, where ``extras`` holds the membership trajectory
    ``active`` bool[E, N], ``invalidated`` i64[N] (recoveries and
    retirements), ``node_up`` (``None`` without failures) and, when
    asked for, ``telemetry`` and ``chains``.  ``block_events`` sends a
    CPU run through the block runner with that block length (on the
    card it overrides ``BLOCK_EVENTS``)."""
    check_step_mode(mode)
    device = resolve_device(device)
    ccold = cloud_cold_draws(len(trace), cfg.cloud_cold_prob, rng_seed)
    node, outcome, fracs, extras = _replay_autoscale(
        cfg, asc, trace, device, mode, failures, block_events, telemetry,
        chains, ccold)
    return build_result(cfg, trace, node, outcome, ccold), fracs, extras


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
