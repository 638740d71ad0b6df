"""The block runner: K events of the cluster step as one CUDA graph.

The counterpart of the reference's ``_chunk_runner`` /
``_failures_chunk_runner`` (``repro.cluster.engine``), which compile a
chunk's ``lax.scan`` once and run it with a donated carry.  Eager torch
pays the host's dispatch of every small op of an event (~100-200 of
them); a CUDA graph records them once and replays them with no host
work between kernels.

A :class:`BlockRunner` owns fixed tensors: the carry (the stacked pool
state and, with failures, the invalidation counts), the tensors the
step reads (routing code, ``unified``, ``cloud``), ``[K]`` event input
buffers (with the ``[K, N]`` up/recover rows), and ``[K]`` node and
outcome output buffers.  Its block runs K events through the unchanged
``engine._make_step`` from the input buffers into the output buffers
and copies the final state back into the carry in place (``vmap`` and
``fused`` rebind the pool state on every event).  Per block of a chunk,
the runner copies the block's events device to device into the input
buffers, replays the graph and copies the outputs out, all on the
current stream, with no host sync; the chunk's last ``c mod K`` events
run through the same step eagerly on the same carry.  On the CPU the
block runs eagerly: the same code, only the capture differs, so the CPU
tests cover the block partition and the carry.

The autoscaled flavour (``autoscaled=True``, for the engine's epoch
loop) adds the membership ``active`` bool[N], which every event reads
as its live mask (``up & active`` with failures), and the epoch's
pressure ``press`` f32[N, 2] and ``dropw`` f32[1], which every event
adds to; its invalidation counts also take retirements.  Between epochs
the engine zeroes the pressure in place and, after the re-split, writes
the resized pools, the membership and the retirement's count back into
the same storage (:meth:`BlockRunner.commit`), so the next replay reads
them.

With telemetry on (``tel=True``) the block also writes, for each of
its K events, the state after it into fixed ``[K, N]`` rows (free MB
and residents per node) and, with failures, the residents the event's
recovery invalidated into a ``[K]`` row; after each replay the runner
copies the rows of the events that end a window into the run's
:class:`~repro_torch.cluster.engine.TelSink` (positions the host knows
from global event indices), so no ``[W, ...]`` window tensor, whose
shape is the run's, is in the graph.  With chains on (``chains=C``) the
chain state the step reads before it routes (each chain's latency so
far, drop flag and deadline) lives in fixed tensors of a capacity that
rounds ``C`` up to a power of two (at least :data:`MIN_CHAIN_CAP`), so
a trace with about as many chains replays the same graph; the block
reads each event's chain row, stage, final-stage flag and cloud cold
flip from ``[K]`` input buffers and writes its miss flag into a ``[K]``
output buffer.

Runners are cached like ``jax.jit``'s programs, keyed on every Python
value the captured step closes over (:func:`block_runner`).  Warm-up and
capture happen when an entry is made, on its own tensors, before any
run's state is loaded.  On CUDA a capture that fails raises: the eager
loop is never a fallback.
"""
from __future__ import annotations

import functools
import time

import torch

from ..core.continuum import ClusterConfig
from ..core.pool import get_step_backend
from ..core.registry import REPLACEMENT, ROUTING
from .engine import (ChainAcc, ChainXs, ClusterEvent, EventOut, Pressure,
                     _make_step, _run_events, _snapshot, init_cluster)

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

#: Run counters, for the tests and ``chip_smoke.py``: ``blocks`` full
#: blocks run (on CUDA each is one graph replay), ``eager_events`` the
#: events of the chunks' remainders, ``captures`` graphs captured and
#: ``capture_s`` the host seconds spent warming up and capturing them.
STATS = {"blocks": 0, "eager_events": 0, "captures": 0, "capture_s": 0.0}


def _b1():
    """The fused step's kernel wrapper, whose launch count the runner
    keeps right across capture and replay (imported at call time: the
    kernels import the core, never the other way at import)."""
    from ..kernels.pool_step import evict_place_cuda
    return evict_place_cuda


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
                 chain_cap: int = 0):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        n, k, dev = n_nodes, block, device
        self.device, self.n_nodes, self.block = dev, n, k
        self.failing, self.autoscaled = failing, autoscaled
        self.tel, self.chain_cap = tel, chain_cap
        self.routing = torch.zeros(1, dtype=torch.int64, device=dev)
        self.unified = torch.zeros(n, dtype=torch.bool, device=dev)
        self.cloud = torch.zeros(2, dtype=torch.float32, device=dev)
        self.pools = init_cluster(ClusterConfig(
            node_mb=(1.0,) * n, small_frac=(0.5,) * n, unified=(False,) * n,
            max_slots=max_slots), dev)
        self.inval = torch.zeros(n, dtype=torch.int32, device=dev)
        self.active = torch.ones(n, dtype=torch.bool, device=dev)
        self.press = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        self.dropw = torch.zeros(1, dtype=torch.float32, device=dev)
        f32, i32 = torch.float32, torch.int32
        self.events = ClusterEvent(*(
            torch.zeros(k, dtype=dt, device=dev)
            for dt in (f32, i32, f32, i32, f32, f32, i32, i32)))
        self.up = torch.ones((k, n), dtype=torch.bool, device=dev)
        self.recover = torch.zeros((k, n), dtype=torch.bool, device=dev)
        self.node = torch.zeros(k, dtype=i32, device=dev)
        self.outcome = torch.zeros(k, dtype=i32, device=dev)
        # telemetry rows: the state after each event of the block
        self.snap_free = self.snap_occ = self.sink = None
        if tel:
            self.snap_free = torch.zeros((k, n), dtype=f32, device=dev)
            self.snap_occ = torch.zeros((k, n), dtype=i32, device=dev)
        # chains: the per-chain state and the per-event chain data
        self.chain = self.cx = None
        if chain_cap:
            self.chain = ChainAcc(
                lat=torch.zeros(chain_cap, dtype=f32, device=dev),
                dropped=torch.zeros(chain_cap, dtype=torch.bool, device=dev),
                deadline=torch.full((chain_cap,), float("inf"), dtype=f32,
                                    device=dev),
                rtt=self.cloud[0])
            self.cx = ChainXs(*(torch.zeros(k, dtype=dt, device=dev)
                                for dt in (torch.int64, i32, torch.bool,
                                           torch.bool)))
        self.out = EventOut(
            torch.zeros(k, dtype=i32, device=dev) if tel and failing
            else None,
            torch.zeros(k, dtype=i32, device=dev) if chain_cap else None,
            self._snap_row if tel else None)
        self.step = _make_step(self.routing, self.unified, self.cloud, n,
                               mode)
        self.graph = None
        self.launches_per_block = 0
        if dev.type == "cuda":
            self._capture()

    def _snap_row(self, i: int, pools) -> None:
        _snapshot(pools, self.n_nodes, self.snap_free[i], self.snap_occ[i])

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
            outcome, self.n_nodes, count, acc,
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
        """Warm up on a side stream, then capture one block (on the
        runner's own tensors: no run's state is loaded yet)."""
        b1, t0 = _b1(), time.perf_counter()
        before = b1.launches
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._advance(*self._buffers(min(WARMUP_EVENTS, self.block)))
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        warm = b1.launches
        with torch.cuda.graph(graph):
            self._advance(*self._buffers(self.block))
        torch.cuda.synchronize(self.device)
        # the wrapper counted its calls during capture; those kernels run
        # at each replay, and the warm-up's ran on no run's state
        self.launches_per_block = b1.launches - warm
        b1.launches = before
        self.graph = graph
        STATS["captures"] += 1
        STATS["capture_s"] += time.perf_counter() - t0

    def load(self, pools, routing, unified, cloud, active=None,
             deadline=None, sink=None) -> None:
        """Copy a run's initial state and inputs into the fixed tensors:
        an autoscaled run also gives its starting membership, a run with
        chains its deadlines f32[C] (its chain rows start at zero), and a
        run with telemetry its :class:`~repro_torch.cluster.engine.TelSink`."""
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
            c = deadline.shape[0]
            if c > self.chain_cap:
                raise ValueError(f"{c} chains exceed the runner's "
                                 f"capacity of {self.chain_cap}")
            self.chain.lat.zero_()
            self.chain.dropped.zero_()
            self.chain.deadline[:c].copy_(deadline)
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
            _b1().launches += self.launches_per_block
        STATS["blocks"] += 1

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
        """Step one uploaded chunk (``[c]`` events; ``[c, N]`` masks with
        failures; ``cx`` its chain data with chains) from the carry,
        writing ``node``/``outcome`` i32[c] and, when given, the
        per-event recovery invalidations ``inval`` and chain misses
        ``miss`` i32[c].  ``base`` is the global index of the chunk's
        first event (telemetry's windows)."""
        c, k = node.shape[0], self.block
        full = c - c % k
        for s in range(0, full, k):
            for dst, src in zip(self.events, events):
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
                ClusterEvent(*(a[full:] for a in events)), rest(up),
                rest(recover), node[full:], outcome[full:], c - full,
                None if cx is None else ChainXs(*(a[full:] for a in cx)),
                EventOut(rest(inval), rest(miss),
                         None if self.sink is None
                         else self.sink.at_ends(base + full)))
            STATS["eager_events"] += c - full


@functools.lru_cache(maxsize=CACHE_SIZE)
def _cached(device, n_nodes, max_slots, mode, failing, block, autoscaled,
            tel, chain_cap, routing_specs, replacement_specs) -> BlockRunner:
    return BlockRunner(device, n_nodes, max_slots, mode, failing, block,
                       autoscaled, tel, chain_cap)


def block_runner(device, n_nodes: int, max_slots: int, mode: str,
                 failing: bool, block: int | None = None,
                 autoscaled: bool = False, tel: bool = False,
                 chains: int = 0) -> BlockRunner:
    """The cached runner for this cluster shape and step mode.

    The key holds every Python value the captured step closes over: the
    device, ``n_nodes`` and ``max_slots`` (the shapes), ``mode`` (which
    names the step backend), whether failures are on, the block length,
    whether the run is autoscaled (the live mask and the pressure),
    whether telemetry is on (the snapshot rows), the chain capacity
    (:func:`chain_capacity` of the run's ``chains``, 0 with chains off:
    the chain state's shape), and the registered routing and
    replacement policies (the step runs every registered routing body
    and ``where``-chains every replacement priority, so registering a
    policy makes a new entry).  Everything else a run differs in
    (routing code, ``unified``, ``cloud``, capacities, policy codes,
    membership, deadlines, the window length and the trace's length) is
    data in the runner's fixed tensors or on the host."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if mode not in ("gather", "vmap"):
        get_step_backend(mode)          # unknown names fail here
    return _cached(device, n_nodes, max_slots, mode, bool(failing),
                   BLOCK_EVENTS if block is None else int(block),
                   bool(autoscaled), bool(tel), chain_capacity(chains),
                   ROUTING.specs(), REPLACEMENT.specs())
