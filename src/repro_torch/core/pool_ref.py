"""Sequential warm pool in pure Python and numpy; port of
``repro.core.pool_ref`` (the serving runtime's pool bookkeeping).

A dynamic set of containers with greedy sequential eviction in
replacement-policy order, f32-mirrored step by step like the reference.
This slice carries the static pool: ``PoolConfig.resize_policy`` stays
``None`` (vertical scaling is ROADMAP A11), so the reference's resize-on
branches of ``access`` and ``resize`` have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import operator

import numpy as np

from .registry import REPLACEMENT, SlotStats
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
    # the memory limit and observed usage of the reference's vertical
    # scaling; both equal size_mb in a static pool
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
        if idle:
            c = min(idle, key=lambda c: c.uid)
            c.last_use = t
            c.freq += 1.0
            c.gd_priority = self._gd(c.freq, cold_cost, c.size_mb)
            c.busy_until = _f32(_f32(t) + _f32(warm_dur))
            metrics.hits += 1
            metrics.exec_time = _f32(_f32(metrics.exec_time) + _f32(warm_dur))
            return "hit"

        # 2) cold start: must place a new container of size_mb.
        if size_mb > self.cfg.capacity_mb + 1e-9:
            metrics.drops += 1
            return "drop"
        deficit = size_mb - self.free_mb
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
                freed += c.size_mb
            if freed < deficit - 1e-9:
                metrics.drops += 1
                return "drop"
        # slot limit: a slot must be empty after eviction, as in the
        # fixed-size pool state
        if len(self.containers) - len(victims) >= self.cfg.max_slots:
            metrics.drops += 1
            return "drop"
        for c in victims:
            self.containers.remove(c)
            self.free_mb += c.size_mb
            if self.cfg.policy == Policy.GREEDY_DUAL:
                self.clock = max(self.clock, c.gd_priority)
        self.last_victims = victims
        new = Container(func_id=func_id, size_mb=size_mb, last_use=t,
                        freq=1.0,
                        gd_priority=self._gd(1.0, cold_cost, size_mb),
                        busy_until=_f32(_f32(t) + _f32(cold_dur)),
                        alloc_mb=size_mb, used_mb=size_mb)
        self.containers.append(new)
        self.free_mb -= size_mb
        metrics.misses += 1
        metrics.exec_time = _f32(_f32(metrics.exec_time) + _f32(cold_dur))
        return "miss"

    # -- capacity changes (autoscaling) -------------------------------------
    def resize(self, now: float, new_capacity_mb: float) -> list[Container]:
        """Change the pool capacity between epochs (f32-mirrored).

        Evicts lowest-``(priority, uid)`` *idle* containers until the new
        capacity is respected; busy containers survive, so a hard shrink
        can leave ``free_mb`` negative.  Eviction here does not inflate
        the GreedyDual clock.  Returns the victims (also in
        ``last_victims``)."""
        used = sum(c.size_mb for c in self.containers)
        deficit = float(_f32(_f32(used) - _f32(new_capacity_mb)))
        victims: list[Container] = []
        freed = 0.0
        for c in sorted((c for c in self.containers if c.busy_until <= now),
                        key=lambda c: (self._priority(c), c.uid)):
            if freed >= deficit - 1e-9:
                break
            victims.append(c)
            freed += c.size_mb
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
        used = sum(c.size_mb for c in self.containers)
        return math.isclose(used, self.used_mb, rel_tol=1e-6, abs_tol=1e-6) \
            and used <= self.cfg.capacity_mb + 1e-6
