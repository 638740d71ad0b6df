"""The block runner: K events of the cluster step as one CUDA graph.

The counterpart of the reference's ``_chunk_runner`` /
``_failures_chunk_runner`` (``repro.cluster.engine``), which compile a
chunk's ``lax.scan`` once and run it with a donated carry.  Eager torch
pays the host's dispatch of every small op of an event (~100-200 of
them); a CUDA graph records them once and replays them with no host
work between kernels.

A :class:`BlockRunner` runs ``lanes`` lanes of a sweep group at once
(one for a single run): every tensor but the events has a leading lane
axis.  It owns fixed tensors: the carry (the stacked pool state
``[L * 2N, S]`` and, with failures, the invalidation counts
``[L, N]``), the tensors the step reads (routing codes ``[L]``,
``unified`` ``[L, N]``, ``cloud`` ``[L, 2]``), ``[K]`` event input
buffers, which every lane shares (with the ``[K, L, N]`` up/recover
rows), and ``[K, L]`` node and outcome output buffers.  Its block runs
K events through the unchanged ``engine._make_step`` from the input
buffers into the output buffers and copies the final state back into
the carry in place (``vmap`` and ``fused`` rebind the pool state on
every event).  Per block of a chunk,
the runner copies the block's events device to device into the input
buffers, replays the graph and copies the outputs out, all on the
current stream, with no host sync; the chunk's last ``c mod K`` events
run through the same step eagerly on the same carry.  On the CPU the
block runs eagerly: the same code, only the capture differs, so the CPU
tests cover the block partition and the carry.

The autoscaled flavour (``autoscaled=True``, for the engine's epoch
loop) adds the membership ``active`` bool[L, N], which every event reads
as its live mask (``up & active`` with failures), and the epoch's
pressure ``press`` f32[L, N, 2] and ``dropw`` f32[L], which every event
adds to; its invalidation counts also take retirements.  Between epochs
the engine zeroes the pressure in place and, after the re-split, writes
the resized pools, the membership and the retirement's count back into
the same storage (:meth:`BlockRunner.commit`), so the next replay reads
them.

With telemetry on (``tel=True``) the block also writes, for each of
its K events, the state after it into fixed ``[K, L, N]`` rows (free
MB and residents per node) and, with failures, the residents the
event's recovery invalidated into a ``[K, L]`` row; after each replay
the runner copies the rows of the events that end a window into the
run's :class:`~repro_torch.cluster.engine.TelSink` (positions the host
knows from global event indices), so no ``[W, ...]`` window tensor, whose
shape is the run's, is in the graph.  With chains on (``chains=C``) the
chain state the step reads before it routes (each chain's latency so
far, drop flag and deadline, ``[L, cap]``) lives in fixed tensors of a
capacity that rounds ``C`` up to a power of two (at least
:data:`MIN_CHAIN_CAP`), so a trace with about as many chains replays the
same graph; the block reads each event's chain column, stage and
final-stage flag from ``[K]`` input buffers and each lane's cloud cold
flip from a ``[K, L]`` one, and writes the miss flags into a ``[K, L]``
output buffer.

With vertical scaling on (``resize=True``) the carry's pool state holds
the seven resize fields (limits, usage, the policy's code and floor,
the run totals): ``load`` copies the run's policy code and floor into
it as data, and ``commit`` writes the resized limits back after a
re-split; each event's observed usage comes in through a ``[K]`` input
buffer.

Runners are cached like ``jax.jit``'s programs, keyed on every Python
value the captured step closes over (:func:`block_runner`).  Warm-up and
capture happen when an entry is made, on its own tensors, before any
run's state is loaded.  On CUDA a capture that fails raises: the eager
loop is never a fallback.

A sharded sweep runs runners of several devices from one host thread a
device: a capture runs on its runner's device and side stream in
``thread_local`` mode (another thread's CUDA calls do not break it), one
capture at a time, and the run counters (:data:`STATS`, which is
:data:`repro_torch.obs.STATS`) and B1's launch count are updated under
a lock.
"""
from __future__ import annotations

import functools
import threading
import time

import torch

from ..core.continuum import ClusterConfig
from ..core.pool import get_step_backend
from ..core.registry import REPLACEMENT, RESIZE, ROUTING
from ..obs import STATS, count  # noqa: F401  (STATS: read as graphs.STATS)
from .engine import (ChainAcc, ChainXs, ClusterEvent, EventOut, Pressure,
                     _each, _make_step, _run_events, _run_inputs,
                     _snapshot)

#: Events one graph replay steps.  Replay time per event barely depends
#: on it (the device runs the same kernels; a block's copies and launch
#: are a dozen operations), while a chunk's eager remainder and the
#: capture grow with it: 32 ran the 4,000-event path runs fastest of 32,
#: 128 and 512 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
BLOCK_EVENTS = 32
#: Events the warm-up runs before a capture: it loads every kernel the
#: step launches, builds the fused kernel's library and sets its
#: attributes, none of which a capture may do.
WARMUP_EVENTS = 2
#: Runners kept (each holds a graph and its private memory pool).
CACHE_SIZE = 8
#: The least chain capacity a runner is made with: traces of up to this
#: many chains share one cache entry.
MIN_CHAIN_CAP = 64

#: One capture at a time in the process, whatever its device.
_CAPTURE_LOCK = threading.Lock()


def _b1():
    """The fused step's kernel module, whose launch count the runner
    keeps right across capture and replay (imported at call time: the
    kernels import the core, never the other way at import)."""
    from ..kernels import pool_step
    return pool_step


def chain_capacity(n_chains: int) -> int:
    """The chain rows a runner holds for a run of ``n_chains`` chains
    (0: chains off): a power of two, at least :data:`MIN_CHAIN_CAP`."""
    if not n_chains:
        return 0
    return max(MIN_CHAIN_CAP, 1 << (int(n_chains) - 1).bit_length())


class BlockRunner:
    """K events of one cluster shape and step mode as one replayable
    block; see the module docstring.  Not re-entrant: one run at a
    time uses a runner."""

    def __init__(self, device: torch.device, n_nodes: int, max_slots: int,
                 mode: str, failing: bool, block: int,
                 autoscaled: bool = False, tel: bool = False,
                 chain_cap: int = 0, resize: bool = False, lanes: int = 1):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        n, k, dev, ln = n_nodes, block, device, lanes
        self.device, self.n_nodes, self.block = dev, n, k
        self.lanes = ln
        self.failing, self.autoscaled = failing, autoscaled
        self.tel, self.chain_cap = tel, chain_cap
        self.pools, self.routing, self.unified, self.cloud = _run_inputs(
            [ClusterConfig(node_mb=(1.0,) * n, small_frac=(0.5,) * n,
                           unified=(False,) * n, max_slots=max_slots,
                           resize_policy=0 if resize else None)] * ln, dev)
        self.inval = torch.zeros((ln, n), dtype=torch.int32, device=dev)
        self.active = torch.ones((ln, n), dtype=torch.bool, device=dev)
        self.press = torch.zeros((ln, n, 2), dtype=torch.float32, device=dev)
        self.dropw = torch.zeros(ln, dtype=torch.float32, device=dev)
        f32, i32 = torch.float32, torch.int32
        self.events = ClusterEvent(*(
            torch.zeros(k, dtype=dt, device=dev)
            for dt in (f32, i32, f32, i32, f32, f32, i32, i32)),
            used=torch.zeros(k, dtype=f32, device=dev) if resize else None)
        self.up = torch.ones((k, ln, n), dtype=torch.bool, device=dev)
        self.recover = torch.zeros((k, ln, n), dtype=torch.bool, device=dev)
        self.node = torch.zeros((k, ln), dtype=i32, device=dev)
        self.outcome = torch.zeros((k, ln), dtype=i32, device=dev)
        # telemetry rows: the state after each event of the block
        self.snap_free = self.snap_occ = self.sink = None
        if tel:
            self.snap_free = torch.zeros((k, ln, n), dtype=f32, device=dev)
            self.snap_occ = torch.zeros((k, ln, n), dtype=i32, device=dev)
        # chains: the per-chain state and the per-event chain data
        self.chain = self.cx = None
        if chain_cap:
            self.chain = ChainAcc(
                lat=torch.zeros((ln, chain_cap), dtype=f32, device=dev),
                dropped=torch.zeros((ln, chain_cap), dtype=torch.bool,
                                    device=dev),
                deadline=torch.full((ln, chain_cap), float("inf"),
                                    dtype=f32, device=dev),
                rtt=self.cloud[:, 0])
            self.cx = ChainXs(*(torch.zeros(shape, dtype=dt, device=dev)
                                for shape, dt in ((k, torch.int64), (k, i32),
                                                  (k, torch.bool),
                                                  ((k, ln), torch.bool))))
        self.out = EventOut(
            torch.zeros((k, ln), dtype=i32, device=dev) if tel and failing
            else None,
            torch.zeros((k, ln), dtype=i32, device=dev) if chain_cap
            else None,
            self._snap_row if tel else None)
        self.step = _make_step(self.routing, self.unified, self.cloud, n,
                               mode)
        self.graph = None
        self.launches_per_block = 0
        if dev.type == "cuda":
            self._capture()

    def _snap_row(self, i: int, pools) -> None:
        _snapshot(pools, self.snap_free[i], self.snap_occ[i])

    def _advance(self, events, up, recover, node, outcome, count: int,
                 cx=None, out=None):
        """Step ``count`` events from ``events`` on the carry, writing
        ``node``/``outcome`` (and ``out``'s per-event outputs, with ``cx``
        the events' chain data), and leave the final state in the
        carry."""
        if not self.failing:
            up = recover = None
        acc = (Pressure(self.active, self.press, self.dropw)
               if self.autoscaled else None)
        pools, inval = _run_events(
            self.step, self.pools, self.inval, events, up, recover, node,
            outcome, count, acc,
            None if cx is None else (self.chain, cx), out)
        self._store(pools, inval)

    def _store(self, pools, inval) -> None:
        """Copy a new state into the carry, in place."""
        for a, b in zip(self.pools, pools):
            if a is not None and b is not a:
                a.copy_(b)
        if inval is not self.inval:
            self.inval.copy_(inval)

    def _buffers(self, count: int) -> tuple:
        """``_advance``'s arguments for one block of the fixed buffers."""
        return (self.events, self.up, self.recover, self.node,
                self.outcome, count, self.cx, self.out)

    def _capture(self) -> None:
        """Warm up on a side stream, then capture one block on it (on
        the runner's own tensors: no run's state is loaded yet), with
        the runner's device current."""
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, torch.cuda.device(self.device), \
                _b1().tally_launches() as tally:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._advance(*self._buffers(min(WARMUP_EVENTS,
                                                 self.block)))
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            warm = tally()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                self._advance(*self._buffers(self.block))
            torch.cuda.synchronize(self.device)
            # the wrapper counted its calls during capture apart: those
            # kernels run at each replay; the warm-up's ran on no run's
            # state and are not counted
            self.launches_per_block = tally() - warm
        self.graph = graph
        count("captures", 1)
        count("capture_s", time.perf_counter() - t0)

    def load(self, pools, routing, unified, cloud, active=None,
             deadline=None, sink=None) -> None:
        """Copy a run's initial state and inputs into the fixed tensors:
        the lanes' pools, routing codes, ``unified`` and ``cloud``
        (:func:`~repro_torch.cluster.engine._run_inputs`); an autoscaled
        run also gives its starting membership bool[L, N], a run with
        chains its deadlines f32[L, C] (its chain state starts at zero),
        and a run with telemetry its
        :class:`~repro_torch.cluster.engine.TelSink`."""
        for a, b in zip(self.pools, pools):
            if a is not None:
                a.copy_(b)
        self.routing.copy_(routing)
        self.unified.copy_(unified)
        self.cloud.copy_(cloud)
        self.inval.zero_()
        if self.autoscaled:
            self.active.copy_(active)
        if self.chain is not None:
            c = deadline.shape[-1]
            if c > self.chain_cap:
                raise ValueError(f"{c} chains exceed the runner's "
                                 f"capacity of {self.chain_cap}")
            self.chain.lat.zero_()
            self.chain.dropped.zero_()
            self.chain.deadline[:, :c].copy_(deadline)
        self.sink = sink

    def commit(self, pools, active, cnt) -> None:
        """Take the state the autoscaler left between two epochs: the
        resized pools, the new membership and the residents a retirement
        killed, written into the carry in place for the next replay."""
        self._store(pools, self.inval + cnt)
        self.active.copy_(active)

    def _run_block(self) -> None:
        if self.graph is None:
            self._advance(*self._buffers(self.block))
        else:
            self.graph.replay()
            _b1().add_launches(self.launches_per_block)
        count("blocks", 1)

    def _fold(self, b0: int) -> None:
        """Copy the snapshot rows of the block's window-ending events
        (the block's first is global event ``b0``) into the sink."""
        sink = self.sink
        for j in sink.ends(b0, b0 + self.block):
            w = j // sink.window
            sink.free[w].copy_(self.snap_free[j - b0])
            sink.occ[w].copy_(self.snap_occ[j - b0])

    def run_chunk(self, events: ClusterEvent, up, recover,
                  node: torch.Tensor, outcome: torch.Tensor, base: int = 0,
                  cx: ChainXs | None = None, inval=None, miss=None) -> None:
        """Step one uploaded chunk (``[c]`` events; ``[c, L, N]`` masks
        with failures; ``cx`` its chain data with chains) from the carry,
        writing ``node``/``outcome`` i32[c, L] and, when given, the
        per-event recovery invalidations ``inval`` and chain misses
        ``miss`` i32[c, L].  ``base`` is the global index of the chunk's
        first event (telemetry's windows)."""
        c, k = node.shape[0], self.block
        full = c - c % k
        for s in range(0, full, k):
            for dst, src in zip(self.events, events):
                if dst is not None:
                    dst.copy_(src[s:s + k])
            if self.failing:
                self.up.copy_(up[s:s + k])
                self.recover.copy_(recover[s:s + k])
            if cx is not None:
                for dst, src in zip(self.cx, cx):
                    dst.copy_(src[s:s + k])
            self._run_block()
            node[s:s + k].copy_(self.node)
            outcome[s:s + k].copy_(self.outcome)
            for dst, src in ((inval, self.out.inval), (miss, self.out.miss)):
                if dst is not None:
                    dst[s:s + k].copy_(src)
            if self.sink is not None:
                self._fold(base + s)
        if full < c:
            def rest(a):
                return None if a is None else a[full:]
            self._advance(
                _each(events, lambda a: a[full:]), rest(up),
                rest(recover), node[full:], outcome[full:], c - full,
                None if cx is None else ChainXs(*(a[full:] for a in cx)),
                EventOut(rest(inval), rest(miss),
                         None if self.sink is None
                         else self.sink.at_ends(base + full)))
            count("eager_events", c - full)


@functools.lru_cache(maxsize=CACHE_SIZE)
def _cached(device, n_nodes, max_slots, mode, failing, block, autoscaled,
            tel, chain_cap, resize, lanes, routing_specs, replacement_specs,
            resize_specs) -> BlockRunner:
    return BlockRunner(device, n_nodes, max_slots, mode, failing, block,
                       autoscaled, tel, chain_cap, resize, lanes)


def block_runner(device, n_nodes: int, max_slots: int, mode: str,
                 failing: bool, block: int | None = None,
                 autoscaled: bool = False, tel: bool = False,
                 chains: int = 0, resize: bool = False,
                 lanes: int = 1) -> BlockRunner:
    """The cached runner for this cluster shape, step mode and lane
    count.

    The key holds every Python value the captured step closes over: the
    device, ``n_nodes``, ``max_slots`` and ``lanes`` (the shapes),
    ``mode`` (which
    names the step backend), whether failures are on, the block length,
    whether the run is autoscaled (the live mask and the pressure),
    whether telemetry is on (the snapshot rows), the chain capacity
    (:func:`chain_capacity` of the run's ``chains``, 0 with chains off:
    the chain state's shape), whether vertical scaling is on (the resize
    fields and the shrink pass), and the registered routing, replacement
    and resize policies (the step runs every registered routing body and
    ``where``-chains every replacement priority and, with resize on,
    every resize body, so registering a policy makes a new entry).
    Everything else a run or a lane differs in (routing code,
    ``unified``, ``cloud``, capacities, policy codes, the resize code and
    floor, membership, the autoscaler's parameters, failure masks,
    deadlines, the window length and the trace's length) is data in the
    runner's fixed tensors or on the host."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if mode not in ("gather", "vmap"):
        get_step_backend(mode)          # unknown names fail here
    return _cached(device, n_nodes, max_slots, mode, bool(failing),
                   BLOCK_EVENTS if block is None else int(block),
                   bool(autoscaled), bool(tel), chain_capacity(chains),
                   bool(resize), int(lanes), ROUTING.specs(),
                   REPLACEMENT.specs(),
                   RESIZE.specs() if resize else ())
