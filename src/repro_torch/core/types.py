"""Core datatypes for the KiSS warm-pool simulator (numpy, host side).

A copy of ``repro.core.types`` for the port (which may not import
``repro``).  An *event* is one function invocation ``(t, func_id,
size_mb, cls, warm_dur, cold_dur)``; a warm pool answers it with a HIT
(an idle container of the function exists), a MISS (cold start, evicting
idle containers per the replacement policy until the new one fits) or a
DROP (it cannot be placed, and runs in the cloud).  Size class 0 is
small and 1 large; KiSS routes by class to one of two pools.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as np


class Policy(enum.IntEnum):
    """Warm-pool replacement policy (paper §4.5)."""

    LRU = 0
    GREEDY_DUAL = 1  # FaaSCache-style: priority = clock + freq * cost / size
    FREQ = 2


SMALL = 0
LARGE = 1

# outcome codes, shared by the pool step and the cluster metrics
HIT, MISS, DROP = 0, 1, 2


class Trace(NamedTuple):
    """Struct-of-arrays invocation trace, sorted by time.

    The three chain fields are ``None`` for chainless traces and are
    all-or-none; ``Scenario(..., chains=...)`` reads them (``chained_trace``
    sets them), and a reference ``repro.core.types.Trace`` converts
    field for field (``Trace(*reference_trace)``)."""

    t: np.ndarray          # f32[N] event time (seconds)
    func_id: np.ndarray    # i32[N] function identity
    size_mb: np.ndarray    # f32[N] container memory footprint (MB)
    cls: np.ndarray        # i32[N] size class (0 small, 1 large)
    warm_dur: np.ndarray   # f32[N] execution time on a warm container
    cold_dur: np.ndarray   # f32[N] execution time incl. cold-start init
    chain_id: np.ndarray | None = None   # i32[N] chain instance id
    stage: np.ndarray | None = None      # i32[N] position within the chain
    chain_len: np.ndarray | None = None  # i32[N] total stages in the chain

    CHAIN_FIELDS = ("chain_id", "stage", "chain_len")

    def __len__(self) -> int:
        return int(self.t.shape[0])

    @property
    def has_chains(self) -> bool:
        """True when chain metadata is present (all-or-none validated)."""
        present = [getattr(self, f) is not None for f in self.CHAIN_FIELDS]
        if any(present) and not all(present):
            missing = [f for f, p in zip(self.CHAIN_FIELDS, present)
                       if not p]
            raise ValueError(
                f"Trace chain fields are all-or-none; missing {missing}")
        return all(present)

    def _map(self, f) -> "Trace":
        """Apply ``f`` to every field array, passing ``None`` through: the
        one place slicing semantics live, so the chain fields never drift
        out of step with the core fields."""
        return Trace(*(None if a is None else f(a) for a in self))

    def replace(self, **fields) -> "Trace":
        """A copy with the named field arrays swapped out (namedtuple's
        ``_replace`` breaks here: its length check calls ``len()``, which
        this class overrides to mean the event count)."""
        d = {f: getattr(self, f) for f in self._fields}
        for k, v in fields.items():
            if k not in d:
                raise ValueError(f"Trace has no field {k!r}")
            d[k] = v
        return Trace(**d)

    def sorted_by_time(self) -> "Trace":
        order = np.argsort(self.t, kind="stable")
        return self._map(lambda a: a[order])

    def select(self, mask: np.ndarray) -> "Trace":
        return self._map(lambda a: a[mask])

    def head(self, n: int) -> "Trace":
        """The first ``n`` events (all of them when ``n >= len``); every
        engine is prefix-consistent, so ``head(n)`` replays the first
        ``n`` outcomes of the full run."""
        if n < 0:
            raise ValueError(f"head(n) needs n >= 0, got {n}")
        return self._map(lambda a: a[:n])

    def window(self, t0: float, t1: float) -> "Trace":
        """Events with ``t0 <= t < t1``, absolute times kept (re-zero
        with :meth:`shifted`)."""
        if not t0 <= t1:
            raise ValueError(f"window needs t0 <= t1, got ({t0}, {t1})")
        return self.select((self.t >= t0) & (self.t < t1))

    def shifted(self, dt: float | None = None) -> "Trace":
        """Shift all times by ``dt`` (default: re-zero at the first
        event), in the trace's own f32 so that a quantized trace stays on
        its grid when ``dt`` is grid-aligned."""
        if len(self) == 0:
            return self
        if dt is None:
            dt = -float(self.t[0])
        t = (self.t.astype(np.float32) + np.float32(dt)).astype(self.t.dtype)
        return self.replace(t=t)


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """One warm pool.  ``resize_policy`` (vertical scaling) must stay
    ``None`` until ROADMAP A11 ports the resize registry."""

    capacity_mb: float
    policy: Policy = Policy.LRU
    max_slots: int = 1024  # fixed slot count of the pool state
    resize_policy: int | None = None
    resize_min_mb: float = 0.0

    def __post_init__(self):
        if self.resize_policy is not None:
            raise NotImplementedError(
                "PoolConfig(resize_policy=...): vertical scaling is "
                "ROADMAP A11, not yet ported")


@dataclasses.dataclass(frozen=True)
class KissConfig:
    """The paper's policy: two pools split by a static ratio (default 80-20)
    with a container-size threshold classifier (default 225 MB, §2.5.1)."""

    total_mb: float
    small_frac: float = 0.8
    threshold_mb: float = 225.0
    policy: Policy = Policy.LRU
    # Optional per-pool policy override (policy independence experiments).
    small_policy: Policy | None = None
    large_policy: Policy | None = None
    max_slots: int = 1024

    @property
    def small_pool(self) -> PoolConfig:
        return PoolConfig(self.total_mb * self.small_frac,
                          self.small_policy or self.policy, self.max_slots)

    @property
    def large_pool(self) -> PoolConfig:
        return PoolConfig(self.total_mb * (1.0 - self.small_frac),
                          self.large_policy or self.policy, self.max_slots)


@dataclasses.dataclass
class ClassMetrics:
    """Paper §5.2 metrics, per size class."""

    hits: int = 0
    misses: int = 0        # cold starts
    drops: int = 0
    exec_time: float = 0.0

    @property
    def total_accesses(self) -> int:
        return self.hits + self.misses + self.drops

    @property
    def serviceable(self) -> int:
        return self.hits + self.misses

    @property
    def cold_start_pct(self) -> float:
        n = self.total_accesses
        return 100.0 * self.misses / n if n else 0.0

    @property
    def drop_pct(self) -> float:
        n = self.total_accesses
        return 100.0 * self.drops / n if n else 0.0

    @property
    def hit_rate(self) -> float:
        n = self.total_accesses
        return 100.0 * self.hits / n if n else 0.0

    @property
    def serviceable_mean_s(self) -> float:
        """Mean execution latency over the serviceable (non-dropped)
        invocations, seconds."""
        n = self.serviceable
        return self.exec_time / n if n else 0.0

    def __add__(self, other: "ClassMetrics") -> "ClassMetrics":
        return ClassMetrics(self.hits + other.hits,
                            self.misses + other.misses,
                            self.drops + other.drops,
                            self.exec_time + other.exec_time)


@dataclasses.dataclass
class SimResult:
    small: ClassMetrics
    large: ClassMetrics

    @property
    def overall(self) -> ClassMetrics:
        return self.small + self.large

    def summary(self) -> dict:
        """Stable-keyed metric dict; ``Result.summary()`` exposes a
        superset of these keys."""
        o = self.overall
        return {
            "cold_start_pct": o.cold_start_pct,
            "drop_pct": o.drop_pct,
            "hit_rate": o.hit_rate,
            "small_cold_start_pct": self.small.cold_start_pct,
            "large_cold_start_pct": self.large.cold_start_pct,
            "small_drop_pct": self.small.drop_pct,
            "large_drop_pct": self.large.drop_pct,
            "serviceable": o.serviceable,
            "total": o.total_accesses,
            "exec_time_s": o.exec_time,
            "serviceable_mean_s": o.serviceable_mean_s,
        }
