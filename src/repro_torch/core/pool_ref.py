"""Sequential warm pool in pure Python and numpy; port of
``repro.core.pool_ref`` (the serving runtime's pool bookkeeping).

A dynamic set of containers with greedy sequential eviction in
replacement-policy order, f32-mirrored step by step like the reference.
With ``PoolConfig.resize_policy`` set, a cold start first plans a
shrink of the idle residents toward their observed usage (the resize
registry's ``shrink_amounts`` over numpy), evicts only what that cannot
cover, and keeps the run totals ``acc_used``/``acc_alloc``/``bneck``, as
the reference's pool does; the serving runtime runs it without.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import operator

import numpy as np

from .registry import (REPLACEMENT, RESIZE, ResizeCtx, SlotStats,
                       observed_usage, shrink_amounts)
from .types import ClassMetrics, Policy, PoolConfig

_ids = itertools.count()

# The built-in replacement policies are pure field reads; third-party
# policies take the generic SlotStats path.
_FAST_PRIORITY = {
    int(Policy.LRU): operator.attrgetter("last_use"),
    int(Policy.GREEDY_DUAL): operator.attrgetter("gd_priority"),
    int(Policy.FREQ): operator.attrgetter("freq"),
}


def _f32(x) -> float:
    """Round to float32, mirroring the vectorized pool's arithmetic."""
    return float(np.float32(x))


@dataclasses.dataclass
class Container:
    func_id: int
    size_mb: float
    last_use: float
    freq: float              # hit count on this container (1 at launch)
    gd_priority: float       # GreedyDual priority at last touch
    busy_until: float
    # vertical scaling: the current memory limit (shrinks under pressure,
    # never below max(min_mb, used_mb)) and the observed usage; both
    # equal size_mb in a pool without a resize policy
    alloc_mb: float = 0.0
    used_mb: float = 0.0
    uid: int = dataclasses.field(default_factory=lambda: next(_ids))


class WarmPool:
    """One warm pool with a replacement policy.

    Eviction order (ascending priority = evicted first):
      * LRU:          last_use
      * FREQ:         freq
      * GREEDY_DUAL:  gd_priority = clock + freq * cold_cost / size
    Busy containers (``busy_until > now``) are never evicted.
    """

    def __init__(self, cfg: PoolConfig):
        self.cfg = cfg
        self.containers: list[Container] = []
        self.free_mb = float(cfg.capacity_mb)
        self.clock = 0.0  # GreedyDual inflation clock
        code = REPLACEMENT.resolve(cfg.policy)
        self._fast_pri = _FAST_PRIORITY.get(code)
        self._pri_fn = REPLACEMENT.spec(code).fn
        # vertical scaling: the resize policy's code (None = off) and the
        # run totals behind the utilization metrics
        self._rz_code = (None if cfg.resize_policy is None
                         else RESIZE.resolve(cfg.resize_policy))
        self.acc_used = 0.0    # f32 sum of used_mb over served events
        self.acc_alloc = 0.0   # f32 sum of alloc_mb over served events
        self.bneck = 0         # hits served from a shrunken limit
        # set by access(): containers evicted by the last event — lets the
        # serving runtime destroy the corresponding real model instances.
        self.last_victims: list[Container] = []

    # -- policy priority --------------------------------------------------
    def _priority(self, c: Container) -> float:
        """The registered replacement policy on this container's stats."""
        if self._fast_pri is not None:
            return self._fast_pri(c)
        return float(self._pri_fn(np, SlotStats(
            last_use=c.last_use, freq=c.freq, gd_pri=c.gd_priority,
            size=c.size_mb, busy_until=c.busy_until)))

    def _gd(self, freq: float, cold_cost: float, size: float) -> float:
        # f32-stepwise: clock + (freq * cost) / max(size, 1e-6)
        m = _f32(_f32(freq) * _f32(cold_cost))
        d = _f32(m / _f32(max(size, 1e-6)))
        return _f32(_f32(self.clock) + d)

    # -- event step --------------------------------------------------------
    def access(self, t: float, func_id: int, size_mb: float,
               warm_dur: float, cold_dur: float,
               metrics: ClassMetrics) -> str:
        """Process one invocation; returns 'hit' | 'miss' | 'drop'."""
        self.last_victims = []
        # 1) an idle container of this function (lowest uid first)
        idle = [c for c in self.containers
                if c.func_id == func_id and c.busy_until <= t]
        cold_cost = _f32(_f32(cold_dur) - _f32(warm_dur))
        rz = self._rz_code is not None
        if idle:
            c = min(idle, key=lambda c: c.uid)
            c.last_use = t
            c.freq += 1.0
            c.gd_priority = self._gd(c.freq, cold_cost, c.size_mb)
            c.busy_until = _f32(_f32(t) + _f32(warm_dur))
            metrics.hits += 1
            metrics.exec_time = _f32(_f32(metrics.exec_time) + _f32(warm_dur))
            if rz:
                self.acc_used = _f32(_f32(self.acc_used) + _f32(c.used_mb))
                self.acc_alloc = _f32(_f32(self.acc_alloc)
                                      + _f32(c.alloc_mb))
                self.bneck += int(c.alloc_mb < c.size_mb)
            return "hit"

        # 2) cold start: must place a new container of size_mb.
        if size_mb > self.cfg.capacity_mb + 1e-9:
            metrics.drops += 1
            return "drop"
        # 2a) vertical scaling: plan the shrink pass (residents give up
        #     headroom toward their usage before anything is evicted),
        #     but commit nothing until the drop checks pass: a dropped
        #     event leaves the pool untouched.
        shrink_plan: list[tuple[Container, float]] = []
        free1 = self.free_mb
        if rz and self.containers:
            cs = list(self.containers)
            want = _f32(_f32(size_mb) - _f32(self.free_mb))
            ctx = ResizeCtx(
                used=np.array([c.used_mb for c in cs], np.float32),
                alloc=np.array([c.alloc_mb for c in cs], np.float32),
                size=np.array([c.size_mb for c in cs], np.float32),
                idle=np.array([c.busy_until <= t for c in cs], bool),
                valid=np.ones(len(cs), bool),
                min_mb=np.float32(self.cfg.resize_min_mb),
                deficit=np.float32(max(want, 0.0)),
                free=np.float32(self.free_mb),
                capacity=np.float32(self.cfg.capacity_mb))
            shrink = shrink_amounts(np, np.int32(self._rz_code), ctx)
            shrink_plan = [(c, float(s)) for c, s in zip(cs, shrink)
                           if s > 0.0]
            free1 = _f32(_f32(self.free_mb) + _f32(float(np.sum(shrink))))
        alloc_after = {c.uid: _f32(_f32(c.alloc_mb) - _f32(s))
                       for c, s in shrink_plan}

        def held(c: Container) -> float:
            """What evicting ``c`` frees: its post-shrink limit."""
            return alloc_after.get(c.uid, c.alloc_mb) if rz else c.size_mb

        deficit = size_mb - free1
        victims: list[Container] = []
        if deficit > 1e-9:
            evictable = sorted(
                (c for c in self.containers if c.busy_until <= t),
                key=lambda c: (self._priority(c), c.uid))
            freed = 0.0
            for c in evictable:
                if freed >= deficit - 1e-9:
                    break
                victims.append(c)
                freed += held(c)
            if freed < deficit - 1e-9:
                metrics.drops += 1
                return "drop"
        # slot limit: a slot must be empty after eviction, as in the
        # fixed-size pool state
        if len(self.containers) - len(victims) >= self.cfg.max_slots:
            metrics.drops += 1
            return "drop"
        for c, _ in shrink_plan:
            c.alloc_mb = alloc_after[c.uid]
        self.free_mb = free1
        for c in victims:
            self.containers.remove(c)
            self.free_mb += held(c)
            if self.cfg.policy == Policy.GREEDY_DUAL:
                self.clock = max(self.clock, c.gd_priority)
        self.last_victims = victims
        new = Container(func_id=func_id, size_mb=size_mb, last_use=t,
                        freq=1.0,
                        gd_priority=self._gd(1.0, cold_cost, size_mb),
                        busy_until=_f32(_f32(t) + _f32(cold_dur)),
                        alloc_mb=size_mb,
                        used_mb=(float(observed_usage(
                            np, np.int32(func_id), np.float32(size_mb)))
                            if rz else size_mb))
        self.containers.append(new)
        self.free_mb -= size_mb
        metrics.misses += 1
        metrics.exec_time = _f32(_f32(metrics.exec_time) + _f32(cold_dur))
        if rz:
            self.acc_used = _f32(_f32(self.acc_used) + _f32(new.used_mb))
            self.acc_alloc = _f32(_f32(self.acc_alloc) + _f32(size_mb))
        return "miss"

    # -- capacity changes (autoscaling) -------------------------------------
    def resize(self, now: float, new_capacity_mb: float) -> list[Container]:
        """Change the pool capacity between epochs (f32-mirrored).

        Evicts lowest-``(priority, uid)`` *idle* containers until the new
        capacity is respected; busy containers survive, so a hard shrink
        can leave ``free_mb`` negative.  Eviction here does not inflate
        the GreedyDual clock.  With resize on, a resident holds (and its
        eviction frees) its ``alloc_mb``.  Returns the victims (also in
        ``last_victims``)."""
        rz = self._rz_code is not None
        used = sum((c.alloc_mb if rz else c.size_mb)
                   for c in self.containers)
        deficit = float(_f32(_f32(used) - _f32(new_capacity_mb)))
        victims: list[Container] = []
        freed = 0.0
        for c in sorted((c for c in self.containers if c.busy_until <= now),
                        key=lambda c: (self._priority(c), c.uid)):
            if freed >= deficit - 1e-9:
                break
            victims.append(c)
            freed += c.alloc_mb if rz else c.size_mb
        for c in victims:
            self.containers.remove(c)
        self.cfg = dataclasses.replace(self.cfg,
                                       capacity_mb=float(new_capacity_mb))
        self.free_mb = float(_f32(
            _f32(new_capacity_mb) - _f32(_f32(used) - _f32(freed))))
        self.last_victims = victims
        return victims

    def invalidate(self) -> int:
        """Kill every resident: the pool restarts empty at full capacity
        with a reset GreedyDual clock.  Returns the resident count."""
        n = len(self.containers)
        self.containers.clear()
        self.free_mb = float(self.cfg.capacity_mb)
        self.clock = 0.0
        self.last_victims = []
        return n

    # -- introspection ------------------------------------------------------
    @property
    def used_mb(self) -> float:
        return self.cfg.capacity_mb - self.free_mb

    def occupancy_ok(self) -> bool:
        used = sum((c.alloc_mb if self._rz_code is not None else c.size_mb)
                   for c in self.containers)
        return math.isclose(used, self.used_mb, rel_tol=1e-6, abs_tol=1e-6) \
            and used <= self.cfg.capacity_mb + 1e-6
