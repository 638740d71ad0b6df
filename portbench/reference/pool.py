"""One warm pool, one container at a time, in plain Python and numpy.

The yardstick's own copy of the simulator's sequential pool: a dynamic
set of containers, greedy eviction in (priority, launch order) order,
busy containers never evicted, and every stored number rounded the way
the configuration states (float32, step by step).  The rounding is a
parameter, so the control (the same pool in a lower precision) is this
code too.  No module of the program is imported here.
"""
from __future__ import annotations

import array
import dataclasses
import itertools

import numpy as np

HIT, MISS, DROP = 0, 1, 2
REPLACEMENT = ("lru", "greedy_dual", "freq")


_ONE = array.array("f", [0.0])


def f32(x) -> float:
    """Round to float32 (nearest, as a C cast rounds): the precision the
    configurations state."""
    _ONE[0] = x
    return _ONE[0]


def bf16(x) -> float:
    """Round to bfloat16 (nearest, ties to even), through float32: the
    next precision below float32, which the control uses."""
    b = np.array([x], np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return float(b.view(np.float32)[0])


@dataclasses.dataclass
class Container:
    func_id: int
    size_mb: float
    last_use: float
    freq: float
    gd_priority: float
    busy_until: float
    uid: int


class Pool:
    """A warm pool of ``capacity_mb`` and ``max_slots`` slots under one
    replacement policy (``"lru"``: last use; ``"freq"``: hit count;
    ``"greedy_dual"``: clock + freq * cold cost / size).  ``rnd`` rounds
    every stored number (``f32`` or the control's ``bf16``)."""

    def __init__(self, capacity_mb: float, policy: str, max_slots: int,
                 uids, rnd=f32):
        if policy not in REPLACEMENT:
            raise ValueError(f"unknown replacement policy {policy!r}")
        self.capacity = float(capacity_mb)
        self.policy, self.max_slots = policy, max_slots
        self.rnd, self._uids = rnd, uids
        self.containers: list[Container] = []
        self.by_func: dict[int, list[Container]] = {}
        self.free_mb = float(capacity_mb)
        self.clock = 0.0

    def _priority(self, c: Container) -> float:
        if self.policy == "lru":
            return c.last_use
        if self.policy == "freq":
            return c.freq
        return c.gd_priority

    def _gd(self, freq: float, cold_cost: float, size: float) -> float:
        r = self.rnd
        m = r(r(freq) * r(cold_cost))
        return r(r(self.clock) + r(m / r(max(size, 1e-6))))

    def _remove(self, c: Container) -> None:
        self.containers.remove(c)
        self.by_func[c.func_id].remove(c)

    def access(self, t: float, func_id: int, size_mb: float,
               warm_dur: float, cold_dur: float) -> int:
        """One invocation: HIT, MISS (cold start) or DROP."""
        r = self.rnd
        cold_cost = r(r(cold_dur) - r(warm_dur))
        idle = [c for c in self.by_func.get(func_id, ())
                if c.busy_until <= t]
        if idle:
            c = min(idle, key=lambda c: c.uid)
            c.last_use = r(t)
            c.freq += 1.0
            c.gd_priority = self._gd(c.freq, cold_cost, c.size_mb)
            c.busy_until = r(r(t) + r(warm_dur))
            return HIT
        if size_mb > self.capacity + 1e-9:
            return DROP
        deficit = size_mb - self.free_mb
        victims: list[Container] = []
        if deficit > 1e-9:
            order = sorted((c for c in self.containers if c.busy_until <= t),
                           key=lambda c: (self._priority(c), c.uid))
            freed = 0.0
            for c in order:
                if freed >= deficit - 1e-9:
                    break
                victims.append(c)
                freed += c.size_mb
            if freed < deficit - 1e-9:
                return DROP
        if len(self.containers) - len(victims) >= self.max_slots:
            return DROP
        for c in victims:
            self._remove(c)
            self.free_mb += c.size_mb
            if self.policy == "greedy_dual":
                self.clock = max(self.clock, c.gd_priority)
        new = Container(func_id=func_id, size_mb=size_mb, last_use=r(t),
                        freq=1.0, gd_priority=self._gd(1.0, cold_cost,
                                                       size_mb),
                        busy_until=r(r(t) + r(cold_dur)),
                        uid=next(self._uids))
        self.containers.append(new)
        self.by_func.setdefault(func_id, []).append(new)
        self.free_mb -= size_mb
        return MISS

    def resize(self, now: float, capacity_mb: float) -> None:
        """A new capacity between two epochs: evict the lowest
        (priority, launch order) idle containers until it holds; busy
        ones stay, so the free balance may go negative.  No clock
        inflation here."""
        r = self.rnd
        used = sum(c.size_mb for c in self.containers)
        deficit = float(r(r(used) - r(capacity_mb)))
        victims, freed = [], 0.0
        for c in sorted((c for c in self.containers if c.busy_until <= now),
                        key=lambda c: (self._priority(c), c.uid)):
            if freed >= deficit - 1e-9:
                break
            victims.append(c)
            freed += c.size_mb
        for c in victims:
            self._remove(c)
        self.capacity = float(capacity_mb)
        self.free_mb = float(r(r(capacity_mb) - r(r(used) - r(freed))))


def new_uids():
    """Launch numbers: lower is older, the tie-break of every order."""
    return itertools.count()
