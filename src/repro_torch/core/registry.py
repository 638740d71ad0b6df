"""Routing and replacement policy registries, as in ``repro.core.registry``.

Each policy is ONE registered pure function ``fn(xp, ctx)`` written
against an array namespace.  Here ``xp`` is :mod:`repro_torch.core.xp`,
the numpy spelling over torch, so the built-in bodies below are the
reference's own text and take bit-identical float32 decisions.

Policies are identified by a stable integer *code*, assigned in
registration order: the built-ins here take the reference's codes
(routing 0-3, replacement 0-2) and ``repro_torch.sim.policies`` adds
``cost_model`` and ``slack_aware`` as routing codes 4 and 5, as the
reference's ``repro.sim.policies`` does.  A code is data in the engine
(``replacement_priority`` where-chains every registered replacement;
the cluster step evaluates every registered routing and selects one).

The vertical-scaling registry ``RESIZE`` works the same way: a resize
policy is ``fn(xp, ctx)`` over a :class:`ResizeCtx` and proposes
per-resident memory limits; :func:`shrink_amounts` runs every registered
policy as a ``where``-chain on the code and clamps the proposal to the
engine's contract.  :func:`observed_usage` is host numpy only (its
uint32 hash wraps as numpy's does; torch cannot shift uint32 on the
CPU), called with ``np`` as both of the reference's call sites do.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple


class RouteCtx(NamedTuple):
    """Inputs available to a routing decision, one invocation at a time.

    Scalars are 0-d tensors (float32 or int32); ``free``/``cap`` are
    f32[n_nodes] views of the pool each node would serve this request
    from, ``node_up`` the bool[n_nodes] live-node mask (all True without
    failures), and ``chain_slack``/``chain_stage`` the function-chain
    context (``+inf``/``-1`` on chainless traffic)."""

    h1: object            # i32  sticky hash: func_id % n_nodes
    h2: object            # i32  second (Knuth multiplicative) hash
    size: object          # f32  container footprint (MB)
    cls: object           # i32  size class (0 small, 1 large)
    warm: object          # f32  warm execution time (s)
    cold: object          # f32  cold execution time (s)
    free: object          # f32[N] free MB of each node's target pool
    cap: object           # f32[N] capacity MB of each node's target pool
    cloud_rtt_s: object   # f32  edge->cloud round trip (s)
    cloud_cold_prob: object  # f32  cloud cold-start probability
    node_up: object = None   # bool[N] live-node mask (engines populate)
    chain_slack: object = None  # f32  remaining chain slack (s), +inf off
    chain_stage: object = None  # i32  stage within chain, -1 off


class ResizeCtx(NamedTuple):
    """Inputs available to a vertical-scaling (resize) decision.

    A resize policy sees one pool's per-slot state under memory pressure
    and proposes new per-resident memory limits; the engine then clamps
    the proposal (never below ``max(min_mb, used)``, never above the
    current ``alloc``, busy or empty slots untouched) and floors the
    shrink to whole MB so that f32 byte sums stay exact in any order.
    Per-slot arrays are f32[S] (f32[P, S] in the batched step); the
    scalars broadcast against the slot axis in both layouts (``[P, 1]``
    columns in the batched step), so reductions inside a policy use
    ``xp.sum(..., axis=-1, keepdims=True)``."""

    used: object      # f32[S]  observed usage per resident (MB)
    alloc: object     # f32[S]  current memory limit per resident (MB)
    size: object      # f32[S]  launch footprint per resident (MB)
    idle: object      # bool[S] resident and not busy (shrinkable)
    valid: object     # bool[S] slot holds a resident
    min_mb: object    # f32     configured floor for any limit
    deficit: object   # f32     bytes still needed after free (>= 0)
    free: object      # f32     pool free MB before shrinking
    capacity: object  # f32     pool capacity MB


class SlotStats(NamedTuple):
    """Per-container statistics a replacement policy may rank by (lower
    priority = evicted first); f32 arrays over the pool's slots."""

    last_use: object
    freq: object
    gd_pri: object        # GreedyDual priority maintained by the pool
    size: object          # container footprint (MB)
    busy_until: object


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    name: str
    code: int
    fn: Callable
    needs_free: bool = True   # routing only: reads ctx.free?


class PolicyRegistry:
    """Ordered name -> code -> pure-function registry for one policy kind."""

    def __init__(self, kind: str):
        self.kind = kind
        self._specs: list[PolicySpec] = []
        self._by_name: dict[str, PolicySpec] = {}
        self._hooks: list[Callable[[], None]] = []

    def register(self, name: str, *, needs_free: bool = True):
        """Decorator: register ``fn(xp, ctx_or_stats)`` under ``name``.

        Codes are assigned in registration order and never reused; a
        duplicate name is an error (policies are process-global)."""
        if not isinstance(name, str) or not name:
            raise ValueError(f"{self.kind} policy name must be a non-empty "
                             f"string, got {name!r}")

        def deco(fn):
            if name in self._by_name:
                raise ValueError(
                    f"{self.kind} policy {name!r} is already registered")
            spec = PolicySpec(name=name, code=len(self._specs), fn=fn,
                              needs_free=needs_free)
            self._specs.append(spec)
            self._by_name[name] = spec
            for hook in self._hooks:
                hook()
            return fn

        return deco

    def on_register(self, hook: Callable[[], None]) -> None:
        """Run ``hook()`` after every later registration.  The port's
        engine needs none: the block runner's cache keys on the
        registered specs."""
        if hook not in self._hooks:
            self._hooks.append(hook)

    def resolve(self, policy) -> int:
        """Name | code | IntEnum member -> registered integer code."""
        if isinstance(policy, str):
            try:
                return self._by_name[policy].code
            except KeyError:
                raise KeyError(
                    f"unknown {self.kind} policy {policy!r}; registered: "
                    f"{self.names()}") from None
        try:
            code = int(policy)
            if code != policy:   # 1.9 must not silently become policy 1
                raise ValueError
        except (TypeError, ValueError):
            raise KeyError(f"cannot resolve {self.kind} policy "
                           f"{policy!r} (want a name or an integer code)"
                           ) from None
        if not 0 <= code < len(self._specs):
            raise KeyError(f"unknown {self.kind} policy code {code}; "
                           f"registered: {self.names()}")
        return code

    def spec(self, policy) -> PolicySpec:
        return self._specs[self.resolve(policy)]

    def specs(self) -> tuple[PolicySpec, ...]:
        return tuple(self._specs)

    def names(self) -> list[str]:
        return [s.name for s in self._specs]

    def __len__(self) -> int:
        return len(self._specs)

    def __contains__(self, policy) -> bool:
        try:
            self.resolve(policy)
            return True
        except KeyError:
            return False


ROUTING = PolicyRegistry("routing")
REPLACEMENT = PolicyRegistry("replacement")
RESIZE = PolicyRegistry("resize")

register_routing = ROUTING.register
register_replacement = REPLACEMENT.register
register_resize_policy = RESIZE.register


def routing_policies() -> list[str]:
    """Names of all registered routing policies, in code order."""
    return ROUTING.names()


def replacement_policies() -> list[str]:
    """Names of all registered replacement policies, in code order."""
    return REPLACEMENT.names()


def resize_policies() -> list[str]:
    """Names of all registered resize (vertical-scaling) policies."""
    return RESIZE.names()


# --------------------------------------------------------------------------
# built-in routing policies (codes 0-3), bodies as in the reference
# --------------------------------------------------------------------------

def _free_frac(xp, ctx: RouteCtx):
    return ctx.free / xp.maximum(ctx.cap, xp.float32(1e-6))


def _nth_masked(xp, mask, j):
    """Index of the ``j``-th True entry of ``mask`` (0-based)."""
    return xp.argmax(xp.cumsum(mask.astype(xp.int32)) == j + 1)


@register_routing("sticky", needs_free=False)
def _sticky(xp, ctx: RouteCtx):
    """Per-function hash (``func_id % n_nodes``), re-steered over the up
    nodes while the home node is down."""
    up = ctx.node_up
    k = xp.sum(up.astype(xp.int32))
    j = xp.mod(ctx.h1, xp.maximum(k, 1))
    cand = _nth_masked(xp, up, j)
    return xp.where(up[ctx.h1], ctx.h1, xp.where(k == 0, ctx.h1, cand))


@register_routing("least_loaded")
def _least_loaded(xp, ctx: RouteCtx):
    """Highest instantaneous free fraction among the *up* nodes wins."""
    frac = xp.where(ctx.node_up, _free_frac(xp, ctx), xp.float32(-xp.inf))
    return xp.argmax(frac)


@register_routing("size_aware", needs_free=False)
def _size_aware(xp, ctx: RouteCtx):
    """Sticky-hash over the *up* nodes whose target pool can ever host
    this container (plain sticky when none can)."""
    can_host = ctx.cap >= ctx.size - xp.float32(1e-9)
    elig = (can_host & ctx.node_up).astype(xp.int32)
    k = xp.sum(elig)
    j = xp.mod(ctx.h1, xp.maximum(k, 1))
    cand = _nth_masked(xp, elig, j)
    return xp.where(k == 0, ctx.h1, cand)


@register_routing("power_of_two")
def _power_of_two(xp, ctx: RouteCtx):
    """Two hashes nominate two candidates; the less loaded *up* one wins."""
    frac = xp.where(ctx.node_up, _free_frac(xp, ctx), xp.float32(-xp.inf))
    return xp.where(frac[ctx.h1] >= frac[ctx.h2], ctx.h1, ctx.h2)


# --------------------------------------------------------------------------
# built-in replacement policies (codes 0-2 == Policy)
# --------------------------------------------------------------------------

@register_replacement("lru")
def _lru(xp, s: SlotStats):
    return s.last_use


@register_replacement("greedy_dual")
def _greedy_dual(xp, s: SlotStats):
    """FaaSCache-style: priority = clock + freq * cold_cost / size, already
    maintained incrementally by the pool in ``gd_pri``."""
    return s.gd_pri


@register_replacement("freq")
def _freq(xp, s: SlotStats):
    return s.freq


def replacement_priority(xp, policy, stats: SlotStats):
    """Eviction priority for ``policy`` carried as *data*: a ``where``
    chain over every registered replacement policy."""
    specs = REPLACEMENT.specs()
    out = specs[0].fn(xp, stats)
    for spec in specs[1:]:
        out = xp.where(policy == spec.code, spec.fn(xp, stats), out)
    return out


# --------------------------------------------------------------------------
# built-in resize (vertical-scaling) policies, bodies as in the reference
# --------------------------------------------------------------------------
# A resize policy returns *proposed* per-slot limits; shrink_amounts
# clamps them to [max(min_mb, used), alloc] and floors the shrink to
# whole MB, so a policy never enforces its own floors.

@register_resize_policy("static")
def _static(xp, ctx: ResizeCtx):
    """No-op: every resident keeps its current limit (KiSS-static, with
    the utilization metrics recorded)."""
    return ctx.alloc


@register_resize_policy("fair_share")
def _fair_share(xp, ctx: ResizeCtx):
    """LaSS-style proportional reclamation: every idle resident gives up
    the same fraction of its reclaimable headroom ``alloc - max(min_mb,
    used)``, scaled so that the total just covers the deficit (or all of
    it, whichever is smaller)."""
    floor = xp.maximum(ctx.min_mb, ctx.used)
    headroom = xp.where(ctx.idle & ctx.valid,
                        xp.maximum(ctx.alloc - floor, xp.float32(0.0)),
                        xp.float32(0.0))
    total = xp.sum(headroom, axis=-1, keepdims=True)
    ratio = xp.minimum(ctx.deficit / xp.maximum(total, xp.float32(1e-6)),
                       xp.float32(1.0))
    return ctx.alloc - headroom * ratio


def resize_limits(xp, policy, ctx: ResizeCtx):
    """Proposed per-slot limits for ``policy`` carried as data: a
    ``where``-chain over every registered resize policy."""
    specs = RESIZE.specs()
    out = specs[0].fn(xp, ctx)
    for spec in specs[1:]:
        out = xp.where(policy == spec.code, spec.fn(xp, ctx), out)
    return out


def shrink_amounts(xp, policy, ctx: ResizeCtx):
    """Per-slot shrink (MB) for ``policy``: the registered policy chain,
    then the engine contract (a limit never drops below ``max(min_mb,
    used)`` and never grows, only idle residents shrink, and the shrink
    is floored to whole MB).  The pool step and the sequential pool both
    call this one function."""
    proposal = resize_limits(xp, policy, ctx)
    floor = xp.maximum(ctx.min_mb, ctx.used)
    headroom = xp.maximum(ctx.alloc - floor, xp.float32(0.0))
    shrink = xp.clip(ctx.alloc - proposal, xp.float32(0.0), headroom)
    return xp.where(ctx.idle & ctx.valid, xp.floor(shrink),
                    xp.float32(0.0))


def observed_usage(xp, func_id, size):
    """Deterministic per-function observed memory usage (MB): a
    Knuth-hash fraction in [~0.55, ~0.95) of the launch footprint,
    floored to whole MB, and at least ``min(size, 1)``.  Called with
    ``xp = numpy`` on host arrays (the uint32 hash wraps by design)."""
    import numpy as _np
    with _np.errstate(over="ignore"):   # uint32 hash wraps by design
        h = ((func_id.astype(xp.uint32) * xp.uint32(2654435761))
             >> xp.uint32(20))
    num = (h % xp.uint32(103)).astype(xp.float32) + xp.float32(140.0)
    u = xp.floor(size.astype(xp.float32) * num * xp.float32(1.0 / 256.0))
    return xp.maximum(u, xp.minimum(size.astype(xp.float32),
                                    xp.float32(1.0)))
