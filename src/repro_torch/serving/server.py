"""Edge-node serving runtime with KiSS as the memory manager; port of
``repro.serving.server``.

``KissServer`` owns a device-memory budget and two warm pools (small /
large model classes, static split — the paper's policy); ``UnifiedServer``
is the baseline (one pool).  A request for a model whose container is
resident is a HIT (warm latency); a non-resident model triggers a COLD
START (a real ``ModelContainer``: weights on the device plus a warm-up),
evicting idle containers per the replacement policy; if the container
cannot fit it is a DROP — the request is "punted to the cloud" (paper §1).
An evicted container is dropped from the server, which frees its device
memory.

The pool bookkeeping *is* ``repro_torch.core.pool_ref.WarmPool``, with the
reference's arithmetic: a model's size is ``param_count() * 4 / 1e6`` MB
before its first instantiation and its real footprint after, and its
class is frozen at first sight.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..core.pool_ref import WarmPool
from ..core.types import ClassMetrics, KissConfig, Policy, PoolConfig
from ..models.config import ModelConfig
from .container import ModelContainer


@dataclasses.dataclass
class ServeResult:
    model_id: str
    status: str              # hit | miss | drop
    latency_s: float
    tokens: Optional[np.ndarray] = None


@dataclasses.dataclass
class RequestStats:
    small: ClassMetrics = dataclasses.field(default_factory=ClassMetrics)
    large: ClassMetrics = dataclasses.field(default_factory=ClassMetrics)

    def cls(self, c: int) -> ClassMetrics:
        return self.large if c else self.small


class _ServerBase:
    def __init__(self, registry: dict[str, ModelConfig], *,
                 threshold_mb: float, container_kwargs: dict | None = None):
        self.registry = registry
        self.threshold_mb = threshold_mb
        self.container_kwargs = container_kwargs or {}
        self.containers: dict[str, ModelContainer] = {}
        self._ids: dict[str, int] = {m: i for i, m in enumerate(registry)}
        self._size_cache: dict[str, float] = {}
        self._class_cache: dict[str, int] = {}
        self.stats = RequestStats()

    # -- helpers ----------------------------------------------------------
    def size_mb(self, model_id: str) -> float:
        if model_id not in self._size_cache:
            # estimate before instantiation: f32 params
            mb = self.registry[model_id].param_count() * 4 / 1e6
            self._size_cache[model_id] = max(mb, 1.0)
        return self._size_cache[model_id]

    def size_class(self, model_id: str) -> int:
        # frozen at first sight: the size estimate refines after the first
        # instantiation and must not flip the model between pools (the pool
        # bookkeeping would desync from the container registry).
        if model_id not in self._class_cache:
            self._class_cache[model_id] = int(
                self.size_mb(model_id) >= self.threshold_mb)
        return self._class_cache[model_id]

    def _pool_for(self, model_id: str) -> WarmPool:
        raise NotImplementedError

    def _instantiate(self, model_id: str) -> ModelContainer:
        c = ModelContainer(self.registry[model_id], **self.container_kwargs)
        # refine the size estimate with the real footprint
        self._size_cache[model_id] = max(c.size_mb, 1.0)
        return c

    # -- request path -------------------------------------------------------
    def submit(self, model_id: str, tokens: np.ndarray, n_new: int = 8,
               now: float | None = None) -> ServeResult:
        now = time.perf_counter() if now is None else now
        pool = self._pool_for(model_id)
        cls = self.size_class(model_id)
        metrics = self.stats.cls(cls)
        size = self.size_mb(model_id)
        t0 = time.perf_counter()
        outcome = pool.access(now, self._ids[model_id], size,
                              warm_dur=0.0, cold_dur=0.0, metrics=metrics)
        for victim in pool.last_victims:
            # the server holds the only reference: its weights are freed
            self.containers.pop(self._id_to_model(victim.func_id), None)
        if outcome == "drop":
            return ServeResult(model_id, "drop",
                               time.perf_counter() - t0)
        if outcome == "miss" or model_id not in self.containers:
            self.containers[model_id] = self._instantiate(model_id)
        toks = self.containers[model_id].generate(tokens, n_new)
        return ServeResult(model_id, outcome, time.perf_counter() - t0,
                           tokens=toks)

    def _id_to_model(self, fid: int) -> str:
        for m, i in self._ids.items():
            if i == fid:
                return m
        raise KeyError(fid)


class KissServer(_ServerBase):
    """The paper's policy managing real model containers."""

    def __init__(self, registry: dict[str, ModelConfig], *, total_mb: float,
                 small_frac: float = 0.8, threshold_mb: float = 225.0,
                 policy: Policy = Policy.LRU,
                 container_kwargs: dict | None = None):
        super().__init__(registry, threshold_mb=threshold_mb,
                         container_kwargs=container_kwargs)
        cfg = KissConfig(total_mb=total_mb, small_frac=small_frac,
                         threshold_mb=threshold_mb, policy=policy)
        self.small_pool = WarmPool(cfg.small_pool)
        self.large_pool = WarmPool(cfg.large_pool)

    def _pool_for(self, model_id: str) -> WarmPool:
        return self.large_pool if self.size_class(model_id) else self.small_pool


class UnifiedServer(_ServerBase):
    """Baseline: one pool, same policy code."""

    def __init__(self, registry: dict[str, ModelConfig], *, total_mb: float,
                 threshold_mb: float = 225.0, policy: Policy = Policy.LRU,
                 container_kwargs: dict | None = None):
        super().__init__(registry, threshold_mb=threshold_mb,
                         container_kwargs=container_kwargs)
        self.pool = WarmPool(PoolConfig(total_mb, policy))

    def _pool_for(self, model_id: str) -> WarmPool:
        return self.pool
