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
from .engine import (ClusterEvent, Pressure, _make_step, _run_events,
                     init_cluster)

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


class BlockRunner:
    """K events of one cluster shape and step mode as one replayable
    block; see the module docstring.  Not re-entrant: one run at a
    time uses a runner."""

    def __init__(self, device: torch.device, n_nodes: int, max_slots: int,
                 mode: str, failing: bool, block: int,
                 autoscaled: bool = False):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        n, k, dev = n_nodes, block, device
        self.device, self.n_nodes, self.block = dev, n, k
        self.failing, self.autoscaled = failing, autoscaled
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
        self.step = _make_step(self.routing, self.unified, self.cloud, n,
                               mode)
        self.graph = None
        self.launches_per_block = 0
        if dev.type == "cuda":
            self._capture()

    def _advance(self, events, up, recover, node, outcome, count: int):
        """Step ``count`` events from ``events`` on the carry, writing
        ``node``/``outcome``, and leave the final state in the carry."""
        if not self.failing:
            up = recover = None
        acc = (Pressure(self.active, self.press, self.dropw)
               if self.autoscaled else None)
        pools, inval = _run_events(
            self.step, self.pools, self.inval, events, up, recover, node,
            outcome, self.n_nodes, count, acc)
        self._store(pools, inval)

    def _store(self, pools, inval) -> None:
        """Copy a new state into the carry, in place."""
        for a, b in zip(self.pools, pools):
            if a is not None and b is not a:
                a.copy_(b)
        if inval is not self.inval:
            self.inval.copy_(inval)

    def _buffers(self):
        return (self.events, self.up, self.recover, self.node,
                self.outcome)

    def _capture(self) -> None:
        """Warm up on a side stream, then capture one block (on the
        runner's own tensors: no run's state is loaded yet)."""
        b1, t0 = _b1(), time.perf_counter()
        before = b1.launches
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._advance(*self._buffers(),
                          min(WARMUP_EVENTS, self.block))
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        warm = b1.launches
        with torch.cuda.graph(graph):
            self._advance(*self._buffers(), self.block)
        torch.cuda.synchronize(self.device)
        # the wrapper counted its calls during capture; those kernels run
        # at each replay, and the warm-up's ran on no run's state
        self.launches_per_block = b1.launches - warm
        b1.launches = before
        self.graph = graph
        STATS["captures"] += 1
        STATS["capture_s"] += time.perf_counter() - t0

    def load(self, pools, routing, unified, cloud, active=None) -> None:
        """Copy a run's initial state and inputs into the fixed tensors
        (an autoscaled run also gives its starting membership)."""
        for a, b in zip(self.pools, pools):
            if a is not None:
                a.copy_(b)
        self.routing.copy_(routing)
        self.unified.copy_(unified)
        self.cloud.copy_(cloud)
        self.inval.zero_()
        if self.autoscaled:
            self.active.copy_(active)

    def commit(self, pools, active, cnt) -> None:
        """Take the state the autoscaler left between two epochs: the
        resized pools, the new membership and the residents a retirement
        killed, written into the carry in place for the next replay."""
        self._store(pools, self.inval + cnt)
        self.active.copy_(active)

    def _run_block(self) -> None:
        if self.graph is None:
            self._advance(*self._buffers(), self.block)
        else:
            self.graph.replay()
            _b1().launches += self.launches_per_block
        STATS["blocks"] += 1

    def run_chunk(self, events: ClusterEvent, up, recover,
                  node: torch.Tensor, outcome: torch.Tensor) -> None:
        """Step one uploaded chunk (``[c]`` events; ``[c, N]`` masks with
        failures) from the carry, writing ``node``/``outcome`` i32[c]."""
        c, k = node.shape[0], self.block
        full = c - c % k
        for s in range(0, full, k):
            for dst, src in zip(self.events, events):
                dst.copy_(src[s:s + k])
            if self.failing:
                self.up.copy_(up[s:s + k])
                self.recover.copy_(recover[s:s + k])
            self._run_block()
            node[s:s + k].copy_(self.node)
            outcome[s:s + k].copy_(self.outcome)
        if full < c:
            self._advance(
                ClusterEvent(*(a[full:] for a in events)),
                None if up is None else up[full:],
                None if recover is None else recover[full:],
                node[full:], outcome[full:], c - full)
            STATS["eager_events"] += c - full


@functools.lru_cache(maxsize=CACHE_SIZE)
def _cached(device, n_nodes, max_slots, mode, failing, block, autoscaled,
            routing_specs, replacement_specs) -> BlockRunner:
    return BlockRunner(device, n_nodes, max_slots, mode, failing, block,
                       autoscaled)


def block_runner(device, n_nodes: int, max_slots: int, mode: str,
                 failing: bool, block: int | None = None,
                 autoscaled: bool = False) -> BlockRunner:
    """The cached runner for this cluster shape and step mode.

    The key holds every Python value the captured step closes over: the
    device, ``n_nodes`` and ``max_slots`` (the shapes), ``mode`` (which
    names the step backend), whether failures are on, the block length,
    whether the run is autoscaled (the live mask and the pressure), and
    the registered routing and replacement policies (the step runs
    every registered routing body and ``where``-chains every replacement
    priority, so registering a policy makes a new entry).  Everything
    else a run differs in (routing code, ``unified``, ``cloud``,
    capacities, policy codes, membership) is data in the runner's fixed
    tensors."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if mode not in ("gather", "vmap"):
        get_step_backend(mode)          # unknown names fail here
    return _cached(device, n_nodes, max_slots, mode, bool(failing),
                   BLOCK_EVENTS if block is None else int(block),
                   bool(autoscaled), ROUTING.specs(), REPLACEMENT.specs())
