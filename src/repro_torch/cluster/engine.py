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

Sweeps (the reference's ``_sweep_cluster*``, ``jax.vmap`` over configs)
run L lanes that share ``n_nodes``, ``max_slots`` and the run's shape as
a leading tensor axis of the same step: the pool state is ``[L * 2N,
S]``, lane-major (row ``lane * 2N + node * 2 + pool``), and the step
reads the routing codes int64[L], ``unified`` bool[L, N], ``cloud``
f32[L, 2] and the live mask bool[L, N].  Routing runs every registered
body once an event for all lanes, on ``[L, N]`` ctx arrays (the lane
spelling of :mod:`repro_torch.core.xp`), and ``vmap``/``fused`` step all
``L * 2N`` rows in one pass (one B1 launch in ``fused``).  Everything a
lane differs in is data: policy codes, capacities, deadlines, resize
codes and floors, failure masks ``[T, L, N]``, the autoscaler's
parameters and membership.  A single run is the one-lane case.

A sharded sweep (``devices=k``, the reference's ``shard_map`` over a
lane mesh) cuts a group's lanes, padded with copies of lane 0 to a
multiple of ``k``, into ``k`` equal shards after every per-lane input is
built, runs shard ``j`` on ``cuda:j`` (every shard on the CPU for a CPU
run), each with its own block runner, and concatenates the lanes, the
pad lanes dropped.  Shards on distinct devices run at once, one host
thread a device; lanes share nothing, so every lane is bitwise its
unsharded self.

The module ends with the numpy oracle's entry points (the reference's
``_simulate_cluster{,_failures,_autoscale}_ref``: ``cluster_outcomes_ref``
on the host, priced by ``build_result``) and the reference's deprecated
``simulate_cluster_jax``/``simulate_cluster_ref``/``sweep_cluster``.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device, sync_point
from ..core import xp
from ..core.compat import deprecated
from ..core.continuum import (Autoscale, ChainPlan, ClusterConfig, Failures,
                              cloud_cold_draws, cluster_outcomes_ref,
                              route_hashes)
from ..core.pool import (Event, PoolState, _evict_place_lax, _first_true,
                         _select, get_step_backend, init_pool, pool_resize,
                         pool_step_batch, stack_pools)
from ..core.registry import ROUTING, RouteCtx, observed_usage
from ..core.types import DROP, HIT, MISS, PoolConfig, Trace
from .. import obs
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


def _device_type(device=None) -> str:
    """``"cuda"`` or ``"cpu"``: the run's device type; ``None`` is the
    host's default run, CUDA where a card is present."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def _device_count(device=None) -> int:
    """The devices a sweep may shard its lanes over: every visible CUDA
    device for a CUDA run, one for a CPU run (torch has one CPU device,
    as JAX has one without its host-platform flag)."""
    if _device_type(device) == "cuda":
        return torch.cuda.device_count()
    return 1


def _lane_devices(k: int, device: torch.device) -> list[torch.device]:
    """Where each of ``k`` shards runs: shard ``j`` on ``cuda:j`` for a
    CUDA run (the reference's mesh takes ``jax.devices()[:k]``), every
    shard on the CPU for a CPU run."""
    if device.type == "cuda":
        return [torch.device("cuda", j) for j in range(k)]
    return [torch.device("cpu")] * k


def check_devices(devices, device=None) -> int | None:
    """Validate (and resolve) a sweep ``devices`` argument, as the
    reference does: ``None`` keeps one device, ``"all"`` means every
    device of the run's type (:func:`_device_count` of ``device``), a
    positive int the first that many.  An invalid value, or a count
    above what is available, raises ``ValueError`` before any work."""
    if devices is None:
        return None
    avail = _device_count(device)
    if isinstance(devices, str):
        if devices != "all":
            raise ValueError("devices must be a positive int, 'all' or "
                             f"None, got {devices!r}")
        return avail
    try:
        ok = (not isinstance(devices, bool) and int(devices) == devices
              and devices >= 1)
    except (TypeError, ValueError):
        ok = False
    if not ok:
        raise ValueError("devices must be a positive int, 'all' or None, "
                         f"got {devices!r}")
    n = int(devices)
    if n > avail:
        raise ValueError(
            f"devices={n} exceeds the {avail} available "
            f"{_device_type(device).upper()} device(s) of this run: pass a "
            "smaller count or 'all'")
    return n


def _on(device: torch.device):
    """``device`` made current for CUDA calls (a no-op on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _shard_lanes(n_lanes: int, devices: int | None, device: torch.device,
                 run) -> list:
    """Run a group's ``n_lanes`` lanes through ``run(lane indices,
    device)``, which returns one output a lane: all of them on
    ``device`` when ``devices`` is ``None``, else as ``devices`` shards
    (the reference's ``_shard_lanes``/``_pad_lanes``): the lanes, padded
    to a multiple of ``devices`` with copies of lane 0, are cut into
    shards of ``ceil(n_lanes / devices)``, shard ``j`` run on
    ``_lane_devices(devices, device)[j]``.  Shards on distinct devices
    run at once, one host thread a device; shards that share a device
    run one after another in its thread (they may share a block
    runner).  A shard that fails raises here, after the others end.
    Returns the real lanes' outputs in order, the pad lanes dropped."""
    if devices is None:
        return run(range(n_lanes), device)
    width = -(-n_lanes // devices)
    idx = list(range(n_lanes)) + [0] * (devices * width - n_lanes)
    shards = [idx[j * width:(j + 1) * width] for j in range(devices)]
    by_device: dict = {}
    for j, d in enumerate(_lane_devices(devices, device)):
        by_device.setdefault(d, []).append(j)
    out = [None] * devices

    def work(d, js):
        with _on(d):
            for j in js:
                out[j] = run(shards[j], d)
    if len(by_device) == 1:
        work(*next(iter(by_device.items())))
    else:
        with ThreadPoolExecutor(max_workers=len(by_device)) as pool:
            futures = [pool.submit(work, d, js)
                       for d, js in by_device.items()]
            for f in futures:
                f.result()
    return [lane for shard in out for lane in shard][:n_lanes]


class ClusterEvent(NamedTuple):
    """One invocation plus its precomputed node hashes (0-d tensors), or
    a whole trace of them (``[T]`` arrays).  ``used`` is the observed
    usage a cold start records (resize only; ``None`` otherwise).  The
    lanes of a sweep share the events."""

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


def cluster_events(trace: Trace, n_nodes: int, device=None, *,
                   resize: bool = False) -> ClusterEvent:
    """The whole trace as ``[T]`` tensors on ``device`` (``None`` is the
    CUDA device)."""
    device = resolve_device(device)
    return ClusterEvent(*_upload(_host_events(trace, n_nodes,
                                              resize=resize), 0,
                                 len(trace), device))


def init_cluster(cfg: ClusterConfig, device=None) -> PoolState:
    """Stack all 2N pools of the cluster on a leading axis, on
    ``device`` (``None`` is the CUDA device)."""
    device = resolve_device(device)
    caps = cfg.pool_caps()
    return stack_pools([
        init_pool(PoolConfig(caps[n, k], cfg.policy, cfg.max_slots,
                             resize_policy=cfg.resize_policy,
                             resize_min_mb=cfg.resize_min_mb), device)
        for n in range(cfg.n_nodes) for k in range(2)])


def _run_inputs(configs, device):
    """The lanes' initial pools, stacked lane-major on one leading axis
    (``[L * 2N, S]``: lane, node, pool; built on the host and copied over
    once a field), and the tensors the step reads: the routing codes
    int64[L], ``unified`` bool[L, N] and ``cloud`` f32[L, 2] ``(rtt,
    cold_prob)``.  ``configs`` is one :class:`ClusterConfig` (one lane)
    or a sequence of them with one ``n_nodes`` and ``max_slots``."""
    if isinstance(configs, ClusterConfig):
        configs = [configs]
    host = [init_cluster(c, "cpu") for c in configs]
    pools = PoolState(*(None if xs[0] is None
                        else torch.cat(xs).to(device)
                        for xs in zip(*host)))
    return (pools,
            torch.tensor([int(c.routing) for c in configs],
                         dtype=torch.int64, device=device),
            torch.tensor([c.unified for c in configs], dtype=torch.bool,
                         device=device),
            torch.tensor([[c.cloud_rtt_s, c.cloud_cold_prob]
                          for c in configs], dtype=torch.float32,
                         device=device))


def _stack_configs(configs, what: str) -> list:
    """Validate a sweep group's configs (the reference's refusals): they
    must share ``n_nodes`` and ``max_slots`` (the stacked shapes) and
    agree on vertical scaling on or off (the resize fields exist or not;
    which policy and floor run is per-lane data).  Returns them as a
    list; :func:`_run_inputs` stacks them when a run loads them."""
    configs = list(configs)
    if not configs:
        raise ValueError(f"{what}: configs must be non-empty")
    n, slots = configs[0].n_nodes, configs[0].max_slots
    if any(c.n_nodes != n or c.max_slots != slots for c in configs):
        raise ValueError(f"{what}: configs must share n_nodes and "
                         f"max_slots")
    rz = configs[0].resize_policy is not None
    if any((c.resize_policy is not None) != rz for c in configs):
        raise ValueError(f"{what}: configs must agree on vertical scaling "
                         "on/off (repro_torch.sim.sweep buckets mixed "
                         "groups for you)")
    return configs


def _route(routing: torch.Tensor, ev: ClusterEvent, free_t, cap_t, rtt,
           cold_prob, node_up, chain_slack, chain_stage) -> torch.Tensor:
    """The routing decision of every lane: every registered policy runs
    once on the event's :class:`RouteCtx` (the same bodies as the
    reference's, on the torch ``xp``): the per-node arrays are ``[L, N]``
    :class:`~repro_torch.core.xp.XTensor` rows, the per-lane scalars
    (``rtt``, ``cold_prob``, ``chain_slack``) ``[L, 1]`` and the event's
    0-d, so each body answers ``[L, 1]`` (the lane spelling), and
    ``routing`` (int64[L] codes) selects one answer a lane.  Returns the
    nodes as int64[L]."""
    lanes = free_t.shape[0]
    ctx = RouteCtx(h1=ev.h1, h2=ev.h2, size=ev.size, cls=ev.cls,
                   warm=ev.warm, cold=ev.cold, free=xp.asx(free_t),
                   cap=xp.asx(cap_t), cloud_rtt_s=rtt,
                   cloud_cold_prob=cold_prob, node_up=node_up,
                   chain_slack=chain_slack, chain_stage=chain_stage)
    nodes = torch.cat([torch.broadcast_to(spec.fn(xp, ctx), (lanes, 1)).to(
        torch.int64) for spec in ROUTING.specs()], 1)            # [L, R]
    return nodes.gather(1, routing.view(lanes, 1)).view(lanes).as_subclass(
        torch.Tensor)


def _invalidate_nodes(pools: PoolState, mask_n: torch.Tensor):
    """Kill every resident of the masked nodes (``mask_n`` bool[L, N]:
    failure recovery, node retirement): their pools restart empty at
    their capacity with a reset GreedyDual clock; with resize on, the
    residents' limits and usage die with them and the run totals stay.
    Returns ``(count i32[L, N] residents killed, cleared pools)``."""
    cnt2 = pools.valid.sum(-1, dtype=torch.int32)              # [L * 2N]
    cnt = torch.where(mask_n, cnt2.view(mask_n.shape + (2,)).sum(
        -1, dtype=torch.int32), 0)
    m2 = mask_n.unsqueeze(-1).expand(mask_n.shape + (2,)).reshape(-1)
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
    """Build the per-event step of L lanes (route, then step each lane's
    routed pool).  ``routing`` is the int64[L] routing codes, ``unified``
    bool[L, N] and ``cloud`` f32[L, 2] ``(cloud_rtt_s, cloud_cold_prob)``,
    all on the run's device; the pool state is ``[L * 2N, S]``,
    lane-major.  ``up_n`` (bool[L, N], optional) is the live-node mask:
    routing reads it through ``RouteCtx.node_up``, and a request routed
    to a down node drops to the cloud with every pool left as it was.
    ``cslack`` (f32[L, 1]) and ``cstage`` (0-d i32), optional, are the
    event's chain slack and stage for ``RouteCtx``; without them the step
    reads the constants ``+inf``/``-1``, so slack-aware policies take
    their slack-rich branch.  Returns ``(pools, node int64[L], outcome
    i32[L])``."""
    n, lanes = n_nodes, routing.shape[0]
    width = 2 * n
    dev = unified.device
    all_up = xp.asx(torch.ones((lanes, n), dtype=torch.bool, device=dev))
    # constants are filled on the device: no host copy inside the loop
    no_slack = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    no_stage = torch.full((), -1, dtype=torch.int32, device=dev)
    # vmap/fused: each lane's row of its own [2N] pools
    pool_ids = torch.arange(width, device=dev)
    # gather: where each lane's pools start in the stacked rows
    lane_rows = (torch.arange(lanes, device=dev) * width if lanes > 1
                 else None)
    rtt, cold_prob = (xp.asx(c) for c in cloud.unsqueeze(-1).unbind(1))
    # any mode beyond gather/vmap is a step backend, resolved once here
    backend = (_evict_place_lax if mode in ("gather", "vmap")
               else get_step_backend(mode))

    def step(pools: PoolState, ev: ClusterEvent, up_n=None, cslack=None,
             cstage=None):
        tgt = torch.where(unified, 0, ev.cls).to(torch.int64)  # [L, N]
        col = tgt.unsqueeze(-1)
        free_t = pools.free.view(lanes, n, 2).gather(2, col).squeeze(2)
        cap_t = pools.capacity.view(lanes, n, 2).gather(2, col).squeeze(2)
        node = _route(routing, ev, free_t, cap_t, rtt, cold_prob,
                      all_up if up_n is None else xp.asx(up_n),
                      no_slack if cslack is None else cslack,
                      no_stage if cstage is None else cstage)  # [L]
        at = node.view(lanes, 1)
        ok = None if up_n is None else up_n.gather(1, at).view(lanes)
        p = node * 2 + tgt.gather(1, at).view(lanes)  # [L] a lane's row
        core_ev = Event(ev.t, ev.func_id, ev.size, ev.cls, ev.warm, ev.cold,
                        ev.used)
        if mode == "gather":
            if lane_rows is not None:
                p = p + lane_rows
            one = PoolState(*(None if a is None else a.index_select(0, p)
                              for a in pools))
            new_one, outcome = pool_step_batch(one, core_ev, backend)
            for a, b, old in zip(pools, new_one, one):
                if a is not None:
                    if ok is not None:      # a down node's pool is frozen
                        b = torch.where(
                            ok.view((lanes,) + (1,) * (b.ndim - 1)), b, old)
                    a.index_copy_(0, p, b)
        else:
            stepped, outs = pool_step_batch(pools, core_ev, backend)
            at = p.view(lanes, 1)
            sel = pool_ids == at                                 # [L, 2N]
            if ok is not None:
                sel = sel & ok.view(lanes, 1)
            sel = sel.view(-1)
            pools = PoolState(*(
                None if a is None else torch.where(
                    sel.view((-1,) + (1,) * (a.ndim - 1)), b, a)
                for a, b in zip(pools, stepped)))
            outcome = outs.view(lanes, width).gather(1, at).view(lanes)
        if ok is not None:
            outcome = torch.where(ok, outcome, DROP)
        return pools, node, outcome

    return step


class Pressure(NamedTuple):
    """An autoscaled run's per-event state: the membership ``active``
    bool[L, N], which is the step's live mask (``up & active`` with
    failures), and the epoch's pressure, ``press`` f32[L, N, 2] (misses +
    2x drops per routed node and size class) and ``dropw`` f32[L] (the
    drops), to which each event adds in place."""

    active: torch.Tensor
    press: torch.Tensor
    dropw: torch.Tensor


def _add_pressure(acc: Pressure, node, cls, outcome) -> None:
    """Add one event's pressure: 1 for a miss, 2 for a drop, at each
    lane's ``(node, cls)``; a drop also adds 1 to the lane's ``dropw``.
    Whole numbers, so the f32 sums are exact in any order."""
    lanes = node.shape[0]
    drop = (outcome == DROP).to(torch.float32)                  # [L]
    w = (outcome == MISS).to(torch.float32) + 2.0 * drop
    acc.press.view(lanes, -1).scatter_add_(
        1, (node * 2 + cls).view(lanes, 1), w.view(lanes, 1))
    acc.dropw.add_(drop)


class ChainXs(NamedTuple):
    """Per-event chain data (``[T]`` tensors, the lanes share the trace's
    chains): the dense chain row (int64, an ``index_select`` index), the
    stage (i32), whether the event is its chain's final stage, and each
    lane's pre-drawn cloud cold flip that prices a dropped stage (bool
    ``[T, L]``)."""

    cid: torch.Tensor
    stage: torch.Tensor
    last: torch.Tensor
    ccold: torch.Tensor


class ChainAcc(NamedTuple):
    """A run's chain state on its device: the latency so far ``lat``
    f32[L, C] and ``dropped`` bool[L, C], which each event of a chain
    writes in its column in place, and what the step reads: ``deadline``
    f32[L, C] and each lane's cloud round trip ``rtt`` f32[L] that a drop
    pays."""

    lat: torch.Tensor
    dropped: torch.Tensor
    deadline: torch.Tensor
    rtt: torch.Tensor


def _chain_xs_np(plan: ChainPlan, ccold: np.ndarray) -> ChainXs:
    """The plan's per-event arrays on the host, in the dtypes the step
    reads, with the lanes' cloud cold flips ``ccold`` bool[T, L]; a run
    uploads them a chunk at a time."""
    return ChainXs(cid=np.asarray(plan.cid, np.int64),
                   stage=np.asarray(plan.stage, np.int32),
                   last=np.asarray(plan.last, bool),
                   ccold=np.asarray(ccold, bool))


def _chain_acc(deadline: torch.Tensor, cloud: torch.Tensor) -> ChainAcc:
    """Zeroed chain state for the deadlines f32[L, C], on their device."""
    return ChainAcc(lat=torch.zeros_like(deadline),
                    dropped=torch.zeros_like(deadline, dtype=torch.bool),
                    deadline=deadline, rtt=cloud[:, 0])


def _chain_pre(acc: ChainAcc, c: torch.Tensor):
    """The event's chain view before its step (the reference's
    ``_chain_pre``): each lane's latency so far and deadline, both
    f32[L, 1], and the slack ``deadline - latency`` f32[L, 1] that routing
    reads.  ``c`` is the chain's column as an int64[1] tensor."""
    lat = acc.lat.index_select(1, c)
    dl = acc.deadline.index_select(1, c)
    return lat, dl, dl - lat


def _chain_event(acc: ChainAcc, c: torch.Tensor, last, ccold, lat, dl,
                 ev: ClusterEvent, outcome: torch.Tensor) -> torch.Tensor:
    """Fold one stepped event into its chain's column, in place (the
    reference's ``_chain_event``, its f32 operations in its order): price
    the stage (hit -> warm, miss -> cold, drop -> RTT + cold or warm by
    the lane's pre-drawn flip ``ccold`` bool[L]), add it to the latency,
    note a drop, and judge the deadline if this is the final stage (a
    dropped stage misses whatever the time).  Returns the miss flags
    bool[L]."""
    stage_lat = torch.where(
        outcome == HIT, ev.warm,
        torch.where(outcome == MISS, ev.cold,
                    acc.rtt + torch.where(ccold, ev.cold, ev.warm)))
    final = lat.view(-1) + stage_lat
    dropped = acc.dropped.index_select(1, c).view(-1) | (outcome == DROP)
    acc.lat.index_copy_(1, c, final.unsqueeze(1))
    acc.dropped.index_copy_(1, c, dropped.unsqueeze(1))
    return last & (dropped | (final > dl.view(-1)))


def _n_windows(n_events: int, window: int) -> int:
    return -(-n_events // window)


def _snapshot(pools: PoolState, free_out: torch.Tensor,
              occ_out: torch.Tensor) -> None:
    """Write the state after an event into ``free_out`` f32[L, N] (free
    MB per node, the node's two pools summed as the reference sums them)
    and ``occ_out`` i32[L, N] (resident containers per node), in place."""
    torch.sum(pools.free.view(free_out.shape + (2,)), -1, out=free_out)
    torch.sum(pools.valid.view(occ_out.shape + (-1,)), -1,
              dtype=torch.int32, out=occ_out)


class TelSink:
    """The telemetry a run keeps on its device: the state after each
    window's last event, free MB ``free`` f32[W, L, N] and residents
    ``occ`` i32[W, L, N] (the reference's snapshot columns, last write
    wins), for each of ``lanes`` lanes.  Window ``w`` holds global events
    ``[w * window, (w + 1) * window)``; the last window may be short."""

    def __init__(self, window: int, n_events: int, n_nodes: int, device,
                 lanes: int = 1):
        w = _n_windows(n_events, window)
        self.window, self.n_events, self.n_nodes = window, n_events, n_nodes
        self.free = torch.zeros((w, lanes, n_nodes), dtype=torch.float32,
                                device=device)
        self.occ = torch.zeros((w, lanes, n_nodes), dtype=torch.int32,
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
                _snapshot(pools, self.free[w], self.occ[w])
        return snap


def _stack_tel(window: int, n_events: int, n_nodes: int, lanes: int,
               device) -> TelSink:
    """One zeroed telemetry sink for every lane of a sweep group (the
    lanes share the window count, so the stack is dense)."""
    return TelSink(window, n_events, n_nodes, device, lanes)


class EventOut(NamedTuple):
    """Per-event outputs beyond node and outcome (``[T, L]`` tensors, or
    ``None`` when the run keeps no such thing): the residents a
    recovery invalidated at the event (telemetry with failures), the
    chain deadline miss (chains), and ``snap(i, pools)``, which records
    the state after event ``i`` (telemetry)."""

    inval: torch.Tensor | None = None
    miss: torch.Tensor | None = None
    snap: object = None


def _run_events(step, pools: PoolState, inval, events: ClusterEvent, up,
                recover, node_out: torch.Tensor, outcome_out: torch.Tensor,
                count: int, acc: Pressure | None = None,
                chain: tuple | None = None, out: EventOut | None = None):
    """Events ``[0, count)`` of ``events`` (``[T]`` tensors), one at a
    time for all lanes, without a host sync.  With failures
    (``up``/``recover`` bool[T, L, N] and ``inval`` i32[L, N] given) each
    event first clears the nodes recovering at it.  An autoscaled run
    passes ``acc``: its ``active`` mask joins the live mask and each
    event adds its pressure.  ``chain`` is ``(ChainAcc, ChainXs)`` with
    chains on: each event routes with its chain's slack and stage and is
    folded into its chain's column.  ``out`` takes the per-event
    telemetry and chain outputs.  Writes each event's nodes and outcomes
    into ``node_out``/``outcome_out`` (i32[T, L]) and returns ``(pools,
    inval)``; in ``gather`` mode the static path updates ``pools`` in
    place, else the returned state is new tensors."""
    out = out or EventOut()
    for i in range(count):
        ev = _each(events, lambda a: a[i])
        live = None if up is None else up[i]
        if recover is not None:
            cnt, pools = _invalidate_nodes(pools, recover[i])
            inval = inval + cnt
            if out.inval is not None:
                out.inval[i].copy_(cnt.sum(-1, dtype=torch.int32))
        if acc is not None:
            live = acc.active if live is None else live & acc.active
        if chain is None:
            pools, node, outcome = step(pools, ev, live)
        else:
            cacc, cx = chain
            c = cx.cid[i:i + 1]
            lat, dl, slack = _chain_pre(cacc, c)
            pools, node, outcome = step(pools, ev, live, slack, cx.stage[i])
            out.miss[i].copy_(_chain_event(
                cacc, c, cx.last[i], cx.ccold[i], lat, dl, ev, outcome))
        if acc is not None:
            _add_pressure(acc, node, ev.cls, outcome)
        if out.snap is not None:
            out.snap(i, pools)
        node_out[i].copy_(node)
        outcome_out[i].copy_(outcome)
    return pools, inval


def _tel_np(window: int, n_nodes: int, free: np.ndarray, occ: np.ndarray,
            cls: np.ndarray, outcome: np.ndarray,
            inval_ev: np.ndarray | None = None,
            miss_ev: np.ndarray | None = None, up: np.ndarray | None = None,
            active: np.ndarray | None = None, retired=()) -> dict:
    """One lane's window arrays under the reference's ``_tel_np`` keys.
    ``free`` f32[W, N] and ``occ`` i32[W, N] are its snapshots.  Counters
    are integer sums of the per-event outputs (exact in any order): the
    counts per (class, outcome), the recovery invalidations ``inval_ev``
    i32[T] plus each retirement ``(e, count)`` in the window of its
    epoch's last event ``e - 1``, and the chain misses ``miss_ev``.  The
    up and active node counts are those of each window's last event
    (``up`` bool[T, N] and ``active`` i64[T] counts; all N without
    them)."""
    t = len(outcome)
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
        "free_mb": np.ascontiguousarray(free),
        "occupancy": occ.astype(np.int64),
        "invalidated": inval,
        "nodes_up": (np.full(n_w, n_nodes, np.int64) if up is None
                     else up[ends].sum(1).astype(np.int64)),
        "nodes_active": (np.full(n_w, n_nodes, np.int64) if active is None
                         else np.asarray(active, np.int64)[ends]),
        "chain_miss": cmiss}


def _chain_np(plan: ChainPlan, lat: np.ndarray, dropped: np.ndarray,
              miss_ev: np.ndarray) -> dict:
    """One lane's per-chain arrays under the reference's ``_chain_np``
    keys: latency and drops from its device state (``lat``/``dropped``
    read back as ``[C']`` rows, ``C' >= C``), ``done`` (a final stage was
    stepped) from the plan and ``missed`` from the per-event miss flags,
    both the OR over the chain's events the reference accumulates.
    Copies the state (a runner's is reused by its next run)."""
    c = plan.n_chains
    done = np.zeros(c, bool)
    done[plan.cid[plan.last]] = True
    missed = np.zeros(c, bool)
    missed[plan.cid[np.asarray(miss_ev) != 0]] = True
    return {"latency": lat[:c].copy(), "dropped": dropped[:c].copy(),
            "done": done, "missed": missed}


def _failure_masks(failures: Failures | None, trace: Trace, n_nodes: int):
    """Per-event up/recover bool[T, N] masks: all up and none recovering
    without a schedule."""
    if failures is None:
        t = len(trace)
        return (np.ones((t, n_nodes), bool),
                np.zeros((t, n_nodes), bool))
    return failures.masks(np.asarray(trace.t), n_nodes)


class _RunData(NamedTuple):
    """What a run uploads beyond the events: each lane's failure masks
    (``lane_masks``, ``(up, recover)`` bool[T, N] a lane) and their stack
    (``masks``, bool[T, L, N] each), or ``None`` with failures off; the
    chain plan's per-event arrays (``cx`` or ``None``); and the lanes'
    chain deadlines f32[L, C] on the device (or ``None``); all on the
    host but the deadlines."""

    lane_masks: list | None
    masks: tuple | None
    cx: ChainXs | None
    deadline: torch.Tensor | None


def _sweep_chain_data(chains, configs, t_len: int, rng_seed: int):
    """A group's chain inputs: one ``ChainPlan`` a lane (the same trace,
    so one shared event structure), per-lane deadlines and per-lane
    common-random-number cloud cold draws.  Returns ``(plan, clouds,
    deadlines f32[L, C])``."""
    chains = list(chains)
    if len(chains) != len(configs) or any(p is None for p in chains):
        raise ValueError("chain sweep: need one ChainPlan per config")
    plan = chains[0]
    if any(p.n_chains != plan.n_chains for p in chains):
        raise ValueError("chain sweep: lanes must share the trace's "
                         "chain structure")
    clouds = [cloud_cold_draws(t_len, c.cloud_cold_prob, rng_seed)
              for c in configs]
    deadline = np.stack([np.asarray(p.deadline[:plan.n_chains], np.float32)
                         for p in chains])
    return plan, clouds, deadline


def _run_data(trace: Trace, n_nodes: int, failures, plan, clouds,
              deadline, device) -> _RunData:
    lane_masks = masks = None
    if failures is not None:
        lane_masks = [_failure_masks(f, trace, n_nodes) for f in failures]
        masks = tuple(np.stack([m[k] for m in lane_masks], 1)
                      for k in range(2))
    if plan is None:
        return _RunData(lane_masks, masks, None, None)
    return _RunData(lane_masks, masks,
                    _chain_xs_np(plan, np.stack(clouds, 1)),
                    torch.tensor(deadline, dtype=torch.float32,
                                 device=device))


def _outputs(t_len: int, lanes: int, failing: bool, tel_on: bool,
             ch_on: bool, device) -> tuple:
    """A run's per-event output tensors: nodes and outcomes, and the
    recovery invalidations (telemetry with failures) and the chain miss
    flags (chains), each i32[T, L] or ``None``."""
    def i32():
        return torch.zeros((t_len, lanes), dtype=torch.int32, device=device)
    return (i32(), i32(), i32() if failing and tel_on else None,
            i32() if ch_on else None)


def _vert_np(pools: PoolState, lanes: int) -> list[dict]:
    """Each lane's vertical-scaling run totals of a final pool state on
    the host, per pool in the stacked node-major ``[2N]`` layout, under
    the reference's ``_vert_np`` keys (copies: a runner's state is
    reused by its next run).  Reads the device back: call it inside a
    sync point."""
    used, alloc, bneck = (a.cpu().numpy().reshape(lanes, -1) for a in (
        pools.acc_used, pools.acc_alloc, pools.bneck))
    return [{"acc_used_mb": used[g].copy(), "acc_alloc_mb": alloc[g].copy(),
             "bottlenecks": bneck[g].astype(np.int64)}
            for g in range(lanes)]


def _lane_outputs(trace: Trace, node, outcome, data: _RunData, window,
                  plan, sink, chain, inval_ev, miss_ev, pools: PoolState,
                  active=None, retired=None) -> list:
    """Each lane's ``(node i32[T], outcome i32[T], extras)`` on the host
    from the run's per-event outputs (``[T, L]``) and device state: its
    telemetry, chain and vertical-scaling arrays (``"telemetry"``,
    ``"chains"``, ``"vertical"``).  ``active`` (i64[T, L] live-node
    counts) and ``retired`` (each lane's ``(e, count)`` retirements) are
    an autoscaled run's.  Reads the device back: call it inside a sync
    point."""
    node, outcome = node.cpu().numpy(), outcome.cpu().numpy()
    lanes = node.shape[1]
    n = sink.n_nodes if sink is not None else None
    cols = {}
    for key, a in (("inval", inval_ev), ("miss", miss_ev)):
        cols[key] = None if a is None else a.cpu().numpy()
    if sink is not None:
        free, occ = sink.free.cpu().numpy(), sink.occ.cpu().numpy()
    if plan is not None:
        lat, dropped = chain.lat.cpu().numpy(), chain.dropped.cpu().numpy()
    vert = _vert_np(pools, lanes) if pools.alloc is not None else None
    out = []
    for g in range(lanes):
        o = np.ascontiguousarray(outcome[:, g])
        extras = {}
        if window is not None:
            extras["telemetry"] = _tel_np(
                window, n, free[:, g], occ[:, g], trace.cls, o,
                None if cols["inval"] is None else cols["inval"][:, g],
                None if cols["miss"] is None else cols["miss"][:, g],
                None if data.lane_masks is None else data.lane_masks[g][0],
                None if active is None else active[:, g],
                () if retired is None else retired[g])
        if plan is not None:
            extras["chains"] = _chain_np(plan, lat[g], dropped[g],
                                         cols["miss"][:, g])
        if vert is not None:
            extras["vertical"] = vert[g]
        out.append((np.ascontiguousarray(node[:, g]), o, extras))
    return out


def _replay(configs, trace: Trace, device, mode: str, chunk: int | None,
            failures, block_events: int | None = None,
            window: int | None = None, plan: ChainPlan | None = None,
            clouds=None, deadline: np.ndarray | None = None) -> list:
    """Run the trace for the lanes of ``configs`` (one sweep group);
    returns each lane's ``(node i32[T], outcome i32[T], extras)`` on the
    host, ``extras`` holding ``invalidated`` i64[N] and ``node_up``
    bool[T, N] with failures (``failures``: one schedule or ``None`` a
    lane), ``telemetry`` with a window length ``window`` and ``chains``
    with a chain ``plan`` (the lanes' cloud cold flips ``clouds`` and
    deadlines ``deadline`` f32[L, C]).

    A monolithic CPU run (``chunk`` None) is the host loop; every other
    run goes chunk by chunk through the block runner (on the card a
    monolithic run is one chunk of the whole trace), all lanes in each
    block.  ``block_events`` overrides
    :data:`~repro_torch.cluster.graphs.BLOCK_EVENTS`."""
    from . import graphs
    lanes, n, t_len = len(configs), configs[0].n_nodes, len(trace)
    failing = failures is not None
    tel_on, ch_on = window is not None, plan is not None
    rz_on = configs[0].resize_policy is not None
    host_loop = chunk is None and device.type == "cpu"
    with obs.span("engine.load"):
        ev_np = _host_events(trace, n, resize=rz_on)
        with sync_point(device):
            data = _run_data(trace, n, failures, plan, clouds, deadline,
                             device)
            sink = (_stack_tel(window, t_len, n, lanes, device) if tel_on
                    else None)
            inputs = _run_inputs(configs, device)
        if host_loop:
            pools, routing, unified, cloud = inputs
            step = _make_step(routing, unified, cloud, n, mode)
            up, rec = (_upload(data.masks, 0, t_len, device) if failing
                       else (None, None))
            inval = (torch.zeros((lanes, n), dtype=torch.int32) if failing
                     else None)
            node, outcome, inval_ev, miss_ev = _outputs(
                t_len, lanes, failing, tel_on, ch_on, device)
            chain = _chain_acc(data.deadline, cloud) if ch_on else None
        else:
            chunk = chunk or max(t_len, 1)
            with sync_point(device):
                runner = graphs.block_runner(
                    device, n, configs[0].max_slots, mode, failing,
                    block_events, tel=tel_on,
                    chains=plan.n_chains if ch_on else 0, resize=rz_on,
                    lanes=lanes)
                runner.load(*inputs, deadline=data.deadline, sink=sink)
                host = _outputs(t_len, lanes, failing, tel_on, ch_on, "cpu")
    with obs.span("engine.run"):
        if host_loop:
            pools, inval = _run_events(
                step, pools, inval, ClusterEvent(*_upload(ev_np, 0, t_len,
                                                           device)),
                up, rec, node, outcome, t_len,
                chain=None if chain is None else (
                    chain, ChainXs(*_upload(data.cx, 0, t_len, device))),
                out=EventOut(inval_ev, miss_ev,
                             None if sink is None else sink.at_ends(0)))
        else:
            for s in range(0, t_len, chunk):
                e = min(s + chunk, t_len)
                with sync_point(device):
                    ev = ClusterEvent(*_upload(ev_np, s, e, device))
                    up, rec = (_upload(data.masks, s, e, device) if failing
                               else (None, None))
                    cx = (ChainXs(*_upload(data.cx, s, e, device)) if ch_on
                          else None)
                    outs = _outputs(e - s, lanes, failing, tel_on, ch_on,
                                    device)
                runner.run_chunk(ev, up, rec, outs[0], outs[1], s, cx,
                                 *outs[2:])
                with sync_point(device):
                    for h, d in zip(host, outs):
                        if h is not None:
                            h[s:e].copy_(d)
            node, outcome, inval_ev, miss_ev = host
            inval, chain, pools = runner.inval, runner.chain, runner.pools
    with obs.span("engine.readback"), sync_point(device):
        out = _lane_outputs(trace, node, outcome, data, window, plan, sink,
                            chain, inval_ev, miss_ev, pools)
        if failing:
            inval = inval.cpu().numpy().astype(np.int64)
            for g, (_, _, extras) in enumerate(out):
                extras.update(invalidated=inval[g],
                              node_up=data.lane_masks[g][0])
    return out


def _run_group(configs, trace: Trace, device, rng_seed: int, mode: str,
               chunk_events, failures, telemetry, chains, what: str,
               block_events: int | None = None,
               devices: int | None = None) -> list:
    """One sweep group (or one run: a group of one lane) through
    :func:`_replay` on ``device`` (``None`` is the CUDA device), or with
    ``devices`` (a count :func:`check_devices` resolved) in that many
    shards of its lanes (:func:`_shard_lanes`): each lane's
    ``(ClusterResult, extras)``."""
    with obs.span("sweep.plan"):
        check_step_mode(mode)
        chunk = check_chunk_events(chunk_events)
        configs = _stack_configs(configs, what)
        if failures is not None:
            failures = list(failures)
            if len(failures) != len(configs):
                raise ValueError(f"{what}: need one Failures (or None) per "
                                 "config")
        device = resolve_device(device)
        t_len = len(trace)
        plan = deadline = None
        if chains is not None:
            plan, clouds, deadline = _sweep_chain_data(chains, configs,
                                                       t_len, rng_seed)
        else:
            clouds = [cloud_cold_draws(t_len, c.cloud_cold_prob, rng_seed)
                      for c in configs]

    def run(idx, dev):
        return _replay([configs[i] for i in idx], trace, dev, mode, chunk,
                       None if failures is None
                       else [failures[i] for i in idx], block_events,
                       telemetry, plan, [clouds[i] for i in idx],
                       None if deadline is None else deadline[idx])
    lanes = _shard_lanes(len(configs), devices, device, run)
    with obs.span("engine.results"):
        return [(build_result(c, trace, node, outcome, cc), extras)
                for c, cc, (node, outcome, extras) in zip(configs, clouds,
                                                          lanes)]


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
    ``chains`` (the reference's ``_tel_np``/``_chain_np`` keys).  The
    one-lane case of a sweep group."""
    return _run_group([cfg], trace, device, rng_seed, mode, chunk_events,
                      None if failures is None else [failures], telemetry,
                      None if chains is None else [chains], "simulate",
                      block_events)[0]


class AutoscaleInputs(NamedTuple):
    """The per-lane tensors an autoscaled run reads beyond the static
    run's: the starting split ``frac0`` f32[L, N], ``node_mb`` f32[L, N],
    the f32[L, 5] ``(min_frac, max_frac, gain, spawn_drop_frac,
    retire_drop_frac)`` (+/-inf thresholds when node scaling is off: the
    decision runs the same arithmetic and never fires) and the starting
    membership ``active0`` bool[L, N]."""

    frac0: torch.Tensor
    node_mb: torch.Tensor
    asc: torch.Tensor
    active0: torch.Tensor


def _autoscale_inputs(configs, autoscales, device) -> AutoscaleInputs:
    """The reference's ``_autoscale_inputs`` of each lane, stacked on
    ``device``; one config and one :class:`Autoscale` make one lane."""
    if isinstance(configs, ClusterConfig):
        configs, autoscales = [configs], [autoscales]
    rows = []
    for cfg, asc in zip(configs, autoscales):
        n = cfg.n_nodes
        spawn = asc.spawn_drop_frac if asc.node_scaled else np.inf
        retire = asc.retire_drop_frac if asc.node_scaled else -np.inf
        k = asc.init_active if asc.init_active is not None else n
        rows.append((cfg.small_frac, cfg.node_mb,
                     [asc.min_frac, asc.max_frac, asc.gain, spawn, retire],
                     np.arange(n) < k))
    f32 = dict(dtype=torch.float32, device=device)
    frac0, node_mb, asc, active0 = zip(*rows)
    return AutoscaleInputs(
        torch.tensor(np.asarray(frac0, np.float64), **f32),
        torch.tensor(np.asarray(node_mb, np.float64), **f32),
        torch.tensor(np.asarray(asc, np.float64), **f32),
        torch.tensor(np.stack(active0), dtype=torch.bool, device=device))


def _epoch_end(carry, frac: torch.Tensor, inputs: AutoscaleInputs,
               unified: torch.Tensor, now: torch.Tensor,
               n_events: torch.Tensor) -> torch.Tensor:
    """The autoscaler of every lane after a full epoch, on the device
    without a sync.

    Every KiSS node moves its split ``gain * (p_s - p_l) / (p_s + p_l)``
    toward its pressured class, clipped to ``[min_frac, max_frac]``; the
    non-unified pools resize to ``node_mb * frac`` / ``node_mb * (1 -
    frac)`` at ``now`` (the epoch's last event time); then each lane's
    drop fraction ``dropw / n_events`` spawns its first inactive node or
    retires its active node with the fewest MB in use (its residents are
    invalidated), at most one node a lane, never the last.  The
    reference's f32 operations in its order, as separate ops, each lane
    from its own pressure and parameters.  ``carry`` holds ``pools``,
    ``active``, ``press`` and ``dropw`` and takes the new state with
    ``commit(pools, active, cnt)``.  Returns the new ``frac``
    f32[L, N]."""
    lanes, n = frac.shape
    mn, mx, gain, spawn_th, retire_th = inputs.asc.unsqueeze(-1).unbind(1)
    press, active = carry.press, carry.active
    ps, pl = press[..., 0], press[..., 1]
    tot = ps + pl
    some = tot > 0
    delta = torch.where(some, gain * (ps - pl) / torch.where(some, tot, 1.0),
                        0.0)
    cand = torch.minimum(mx, torch.maximum(frac + delta, mn))
    frac = torch.where(unified, frac, cand)
    caps = torch.stack([inputs.node_mb * frac,
                        inputs.node_mb * (1.0 - frac)], -1).reshape(-1)
    pools = carry.pools
    resized = pool_resize(pools, now, caps)
    kiss = ~unified.unsqueeze(-1).expand(lanes, n, 2).reshape(-1)  # [L*2N]
    pools = PoolState(*(None if o is None else _select(kiss, r, o)
                        for r, o in zip(resized, pools)))
    drop_frac = (carry.dropw / n_events).unsqueeze(-1)            # [L, 1]
    n_active = active.sum(-1, keepdim=True, dtype=torch.int32)
    can_spawn = (drop_frac > spawn_th) & (n_active < n)
    can_retire = ~can_spawn & (drop_frac < retire_th) & (n_active > 1)
    used_n = (pools.capacity - pools.free).view(lanes, n, 2).sum(-1)
    ids = torch.arange(n, device=frac.device)
    spawn = ids == _first_true(~active).unsqueeze(-1)
    retire = ids == torch.where(active, used_n, float("inf")).argmin(
        -1, keepdim=True)
    new_active = torch.where(can_spawn, active | spawn,
                             torch.where(can_retire, active & ~retire,
                                         active))
    cnt, pools = _invalidate_nodes(pools, retire & can_retire)
    carry.commit(pools, new_active, cnt)
    return frac


class _HostCarry:
    """The host loop's carry for the epoch loop, with the block
    runner's interface (``run_chunk``, ``commit``) on tensors that are
    rebound rather than written in place.  ``active`` is the lanes'
    starting membership bool[L, N]; ``chain`` (a :class:`ChainAcc`) and
    ``sink`` (a :class:`TelSink`) are the run's, when chains and
    telemetry are on."""

    def __init__(self, step, pools: PoolState, active: torch.Tensor,
                 chain: ChainAcc | None = None, sink: TelSink | None = None):
        self.step, self.pools = step, pools
        self.chain, self.sink = chain, sink
        dev = active.device
        self.active = active
        self.press = torch.zeros(active.shape + (2,), dtype=torch.float32,
                                 device=dev)
        self.dropw = torch.zeros(active.shape[0], dtype=torch.float32,
                                 device=dev)
        self.inval = torch.zeros(active.shape, dtype=torch.int32, device=dev)

    def run_chunk(self, events, up, recover, node, outcome, base=0,
                  cx=None, inval=None, miss=None) -> None:
        self.pools, self.inval = _run_events(
            self.step, self.pools, self.inval, events, up, recover, node,
            outcome, node.shape[0],
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


def _replay_autoscale(configs, autoscales, trace: Trace, device, mode: str,
                      failures, block_events: int | None = None,
                      window: int | None = None,
                      plan: ChainPlan | None = None, clouds=None,
                      deadline: np.ndarray | None = None):
    """Run the autoscaled trace for the lanes of ``configs`` (one
    :class:`Autoscale` each, one ``epoch_events``); returns each lane's
    ``(node i32[T], outcome i32[T], fracs f32[E, N], extras)`` on the
    host, ``extras`` holding the membership ``active`` bool[E, N],
    ``invalidated`` i64[N], ``node_up`` (bool[T, N], or ``None`` for a
    lane without a schedule) and, when on, ``telemetry`` (retirements in
    the window of their epoch's last event) and ``chains``.

    A CPU run without ``block_events`` is the host loop; every other run
    steps each epoch as one chunk of the block runner (on the card, each
    block of ``BLOCK_EVENTS`` events one graph replay, all lanes in it).
    The whole trace is uploaded once; between epochs nothing is read
    back."""
    from . import graphs
    lanes, n, t_len = len(configs), configs[0].n_nodes, len(trace)
    epoch = autoscales[0].epoch_events
    failing = failures is not None
    tel_on, ch_on = window is not None, plan is not None
    rz_on = configs[0].resize_policy is not None
    spans = _epochs(t_len, epoch)
    with obs.span("engine.load"), sync_point(device):
        data = _run_data(trace, n, failures, plan, clouds, deadline, device)
        sink = (_stack_tel(window, t_len, n, lanes, device) if tel_on
                else None)
        pools, routing, unified, cloud = _run_inputs(configs, device)
        inputs = _autoscale_inputs(configs, autoscales, device)
        ev = cluster_events(trace, n, device, resize=rz_on)
        up, rec = (_upload(data.masks, 0, t_len, device) if failing
                   else (None, None))
        cx = ChainXs(*_upload(data.cx, 0, t_len, device)) if ch_on else None
        node, outcome, inval_ev, miss_ev = _outputs(t_len, lanes, failing,
                                                    tel_on, ch_on, device)
        fracs = torch.empty((len(spans), lanes, n), dtype=torch.float32,
                            device=device)
        actives = torch.empty((len(spans), lanes, n), dtype=torch.bool,
                              device=device)
        retired = torch.zeros((len(spans), lanes), dtype=torch.int32,
                              device=device)
        n_full = torch.full((), float(epoch), dtype=torch.float32,
                            device=device)
        if device.type == "cpu" and block_events is None:
            carry = _HostCarry(
                _make_step(routing, unified, cloud, n, mode), pools,
                inputs.active0,
                _chain_acc(data.deadline, cloud) if ch_on else None, sink)
        else:
            carry = graphs.block_runner(
                device, n, configs[0].max_slots, mode, failing,
                block_events, autoscaled=True, tel=tel_on,
                chains=plan.n_chains if ch_on else 0, resize=rz_on,
                lanes=lanes)
            carry.load(pools, routing, unified, cloud, inputs.active0,
                       data.deadline, sink)
    frac = inputs.frac0

    def cut(a, s, e):
        return None if a is None else a[s:e]
    with obs.span("engine.run"):
        for k, (s, e) in enumerate(spans):
            carry.press.zero_()
            carry.dropw.zero_()
            carry.run_chunk(_each(ev, lambda a: a[s:e]), cut(up, s, e),
                            cut(rec, s, e), node[s:e], outcome[s:e], s,
                            None if cx is None
                            else ChainXs(*(a[s:e] for a in cx)),
                            cut(inval_ev, s, e), cut(miss_ev, s, e))
            if e - s == epoch:
                if tel_on:
                    before = carry.inval.sum(-1, dtype=torch.int32)
                with obs.span("engine.epoch_end", device):
                    frac = _epoch_end(carry, frac, inputs, unified,
                                      ev.t[s:e].amax(), n_full)
                if tel_on:
                    retired[k].copy_(carry.inval.sum(-1, dtype=torch.int32)
                                     - before)
            fracs[k].copy_(frac)
            actives[k].copy_(carry.active)
        with sync_point(device):    # the run ends when the card is done
            actives_np = actives.cpu().numpy()                # [E, L, N]
    with obs.span("engine.readback"), sync_point(device):
        active_ev = retired_by = None
        if tel_on:
            rows = np.concatenate([inputs.active0.cpu().numpy()[None],
                                   actives_np[:-1]]).sum(-1)  # [E, L]
            active_ev = np.repeat(rows, epoch, axis=0)[:t_len]
            ret = retired.cpu().numpy()
            retired_by = [[(e, int(c[g])) for (_, e), c in zip(spans, ret)
                           if c[g]] for g in range(lanes)]
        out = _lane_outputs(trace, node, outcome, data, window, plan, sink,
                            carry.chain, inval_ev, miss_ev, carry.pools,
                            active_ev, retired_by)
        inval = carry.inval.cpu().numpy().astype(np.int64)
        fracs_np = fracs.cpu().numpy()
        lanes_out = []
        for g, (nd, oc, extras) in enumerate(out):
            extras.update(
                invalidated=inval[g],
                node_up=(data.lane_masks[g][0] if failing
                         and failures[g] is not None else None),
                active=np.ascontiguousarray(actives_np[:, g]))
            lanes_out.append((nd, oc, np.ascontiguousarray(fracs_np[:, g]),
                              extras))
        return lanes_out


def _run_group_autoscale(configs, autoscales, trace: Trace, device,
                         rng_seed: int, mode: str, failures, telemetry,
                         chains, what: str,
                         block_events: int | None = None,
                         devices: int | None = None) -> list:
    """One autoscaled sweep group (or one run) through
    :func:`_replay_autoscale`, in ``devices`` shards of its lanes when
    given (as :func:`_run_group`): each lane's ``(ClusterResult, fracs,
    extras)``."""
    with obs.span("sweep.plan"):
        check_step_mode(mode)
        configs = _stack_configs(configs, what)
        autoscales = list(autoscales)
        if len(configs) != len(autoscales):
            raise ValueError(f"{what}: need one Autoscale per config")
        if failures is not None:
            failures = list(failures)
            if len(failures) != len(configs):
                raise ValueError(f"{what}: need one Failures (or None) per "
                                 "config")
            if all(f is None for f in failures):
                failures = None
        e = autoscales[0].epoch_events
        if any(a.epoch_events != e for a in autoscales):
            raise ValueError(f"{what}: configs must share epoch_events"
                             " (sweep() buckets mixed epoch shapes for you)")
        device = resolve_device(device)
        t_len = len(trace)
        plan = deadline = None
        if chains is not None:
            plan, clouds, deadline = _sweep_chain_data(chains, configs,
                                                       t_len, rng_seed)
        else:
            clouds = [cloud_cold_draws(t_len, c.cloud_cold_prob, rng_seed)
                      for c in configs]

    def run(idx, dev):
        return _replay_autoscale(
            [configs[i] for i in idx], [autoscales[i] for i in idx], trace,
            dev, mode, None if failures is None
            else [failures[i] for i in idx], block_events, telemetry, plan,
            [clouds[i] for i in idx],
            None if deadline is None else deadline[idx])
    lanes = _shard_lanes(len(configs), devices, device, run)
    with obs.span("engine.results"):
        return [(build_result(c, trace, node, outcome, cc), fracs, extras)
                for c, cc, (node, outcome, fracs, extras)
                in zip(configs, clouds, lanes)]


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
    card it overrides ``BLOCK_EVENTS``).  The one-lane case of an
    autoscaled sweep group."""
    return _run_group_autoscale(
        [cfg], [asc], trace, device, rng_seed, mode,
        None if failures is None else [failures], telemetry,
        None if chains is None else [chains], "simulate", block_events)[0]


# The reference's entry points, with its return shapes (a sweep's with
# the port's ``device``, ``None`` being the CUDA device).

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


def _sweep_cluster(trace: Trace, configs, rng_seed: int = 0,
                   mode: str = "gather", telemetry: int | None = None,
                   chains=None, devices=None, device=None,
                   block_events: int | None = None):
    """One ``ClusterResult`` per config, all lanes in one run — or, with
    ``telemetry``, ``chains`` (one compiled ``ChainPlan`` per config) or
    vertical scaling, one ``(result, extras)`` pair per config."""
    check_step_mode(mode)
    devices = check_devices(devices, device)
    outs = _run_group(configs, trace, device, rng_seed, mode, None, None,
                      telemetry, chains, "sweep_cluster", block_events,
                      devices)
    return [(r, x) if x else r for r, x in outs]


def _sweep_cluster_failures(trace: Trace, configs, failures,
                            rng_seed: int = 0, mode: str = "gather",
                            telemetry: int | None = None, chains=None,
                            devices=None, device=None,
                            block_events: int | None = None) -> list:
    """A sweep over failure-injected configs: each lane's up/recover
    masks ride as data (``[T, L, N]``); one ``(result, extras)`` pair per
    config."""
    check_step_mode(mode)
    devices = check_devices(devices, device)
    return _run_group(configs, trace, device, rng_seed, mode, None,
                      list(failures), telemetry, chains, "failure sweep",
                      block_events, devices)


def _sweep_cluster_chunked(trace: Trace, configs, rng_seed: int = 0,
                           mode: str = "gather", chunk_events: int = 65536,
                           failures=None, telemetry: int | None = None,
                           chains=None, devices=None, device=None,
                           block_events: int | None = None) -> list:
    """The chunked twin of :func:`_sweep_cluster` and
    :func:`_sweep_cluster_failures`: the chunk loop carries all lanes'
    state at once.  With ``failures`` (one ``Failures`` or ``None`` per
    config), ``telemetry``, ``chains`` or vertical scaling it returns
    ``(result, extras)`` pairs, else plain results."""
    check_step_mode(mode)
    check_chunk_events(chunk_events)
    devices = check_devices(devices, device)
    outs = _run_group(configs, trace, device, rng_seed, mode, chunk_events,
                      failures, telemetry, chains, "chunked sweep",
                      block_events, devices)
    return [(r, x) if x else r for r, x in outs]


def _sweep_cluster_autoscale(trace: Trace, configs, autoscales,
                             failures=None, rng_seed: int = 0,
                             mode: str = "gather",
                             telemetry: int | None = None, chains=None,
                             devices=None, device=None,
                             block_events: int | None = None) -> list:
    """A sweep over autoscaled configs sharing ``n_nodes``,
    ``max_slots`` and ``epoch_events``: min/max/gain, the node-scaling
    thresholds, the initial membership, the splits, the capacities and
    any failure masks are per-lane data.  One ``(result, fracs,
    extras)`` triple per config."""
    check_step_mode(mode)
    devices = check_devices(devices, device)
    return _run_group_autoscale(configs, autoscales, trace, device,
                                rng_seed, mode, failures, telemetry, chains,
                                "autoscale sweep", block_events, devices)


# The numpy oracle's entry points (the reference's ``_simulate_cluster*_ref``):
# ``cluster_outcomes_ref`` on the host, priced by ``build_result``.

def _simulate_cluster_ref(cfg: ClusterConfig, trace: Trace,
                          rng_seed: int = 0,
                          telemetry: int | None = None,
                          chains: ChainPlan | None = None):
    """A static run of the oracle: a ``ClusterResult``, or with
    ``telemetry``, ``chains`` or vertical scaling ``(result, extras)``."""
    cloud_cold = cloud_cold_draws(len(trace), cfg.cloud_cold_prob, rng_seed)
    out = cluster_outcomes_ref(cfg, trace, telemetry=telemetry,
                               chains=chains,
                               chain_cold=(cloud_cold if chains is not None
                                           else None))
    if (telemetry is None and chains is None
            and cfg.resize_policy is None):
        node, outcome = out
        return build_result(cfg, trace, node, outcome, cloud_cold)
    node, outcome, extras = out
    return build_result(cfg, trace, node, outcome, cloud_cold), extras


def _simulate_cluster_failures_ref(
        cfg: ClusterConfig, failures: Failures, trace: Trace,
        rng_seed: int = 0, telemetry: int | None = None,
        chains: ChainPlan | None = None) -> tuple[ClusterResult, dict]:
    """A failure-injected run of the oracle: ``(result, extras)``."""
    cloud_cold = cloud_cold_draws(len(trace), cfg.cloud_cold_prob, rng_seed)
    node, outcome, extras = cluster_outcomes_ref(
        cfg, trace, failures=failures, telemetry=telemetry, chains=chains,
        chain_cold=(cloud_cold if chains is not None else None))
    return build_result(cfg, trace, node, outcome, cloud_cold), extras


def _simulate_cluster_autoscale_ref(
        cfg: ClusterConfig, asc: Autoscale, trace: Trace,
        rng_seed: int = 0, failures: Failures | None = None,
        telemetry: int | None = None, chains: ChainPlan | None = None
        ) -> tuple[ClusterResult, np.ndarray, dict]:
    """An autoscaled run of the oracle: ``(result, fracs, extras)``."""
    cloud_cold = cloud_cold_draws(len(trace), cfg.cloud_cold_prob, rng_seed)
    node, outcome, fracs, extras = cluster_outcomes_ref(
        cfg, trace, autoscale=asc, failures=failures, telemetry=telemetry,
        chains=chains,
        chain_cold=(cloud_cold if chains is not None else None))
    return build_result(cfg, trace, node, outcome, cloud_cold), fracs, extras


@deprecated("repro_torch.sim.simulate(Scenario.cluster(...))")
def simulate_cluster_jax(cfg: ClusterConfig, trace: Trace,
                         rng_seed: int = 0, mode: str = "gather",
                         device=None) -> ClusterResult:
    """Simulate the cluster on ``trace`` with the port's engine, on
    ``device`` (``None`` is the CUDA device); the name is the
    reference's."""
    return _simulate_cluster_torch(cfg, trace, device, rng_seed, mode)


@deprecated("repro_torch.sim.simulate(Scenario.cluster(...), engine='ref')")
def simulate_cluster_ref(cfg: ClusterConfig, trace: Trace,
                         rng_seed: int = 0) -> ClusterResult:
    """The numpy oracle's twin of :func:`simulate_cluster_jax` (same
    result type)."""
    return _simulate_cluster_ref(cfg, trace, rng_seed)


@deprecated("repro_torch.sim.sweep(trace, scenarios)")
def sweep_cluster(trace: Trace, configs, rng_seed: int = 0,
                  mode: str = "gather", device=None) -> list[ClusterResult]:
    """Evaluate many cluster configurations sharing ``n_nodes`` and
    ``max_slots`` as the lanes of one run of the port's engine, on
    ``device`` (``None`` is the CUDA device)."""
    return _sweep_cluster(trace, configs, rng_seed, mode, device=device)
