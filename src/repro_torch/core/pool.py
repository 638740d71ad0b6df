"""Warm pool on torch: fixed-slot state and the one-event transition.

The port of ``repro.core.pool_jax``.  A pool is a :class:`PoolState` of
fixed-size slot arrays; one invocation is a pure function of the state
(:func:`pool_step_batch`), bitwise equal to the reference on quantized
traces:

* greedy eviction in (priority, launch-seq) order == stable sort +
  prefix sum over the freed bytes, evicting the minimal prefix that
  covers the deficit;
* busy containers are never evicted;
* the GreedyDual clock inflates to the largest evicted priority.

JAX's ``vmap`` over pools is written out here: every function takes a
leading pool axis ``P`` (state fields ``[P, S]`` and scalars ``[P]``),
and :func:`pool_step` is the one-pool case.  ``.at[i].set(v)`` becomes a
``where`` against a one-hot slot mask, and ``jnp.argsort(stable=True)``
becomes ``torch.argsort(stable=True)``.  No function here reads a value
back to the host, so a CUDA state steps without synchronizing.

The miss path's evict-and-place decision goes through a registered
*step backend* (the contract above :data:`_STEP_BACKENDS`): ``"lax"`` is
the sort composite under the reference's name, and ``"fused"`` is the
hand-written CUDA kernel of ``repro_torch.kernels.pool_step``.

:func:`pool_resize` changes the capacities between the autoscaler's
epochs, evicting through the same ``(priority, seq)`` prefix.

Vertical scaling (a pool made with ``PoolConfig.resize_policy``) adds
seven fields to the state: each resident's limit ``alloc`` and observed
usage ``used``, the resize policy's code and floor, and the run totals
behind ``Result.utilization_ratio``/``bottleneck_events``.  A miss first
shrinks idle residents toward their usage (:func:`_shrink_pass`, the
resize registry's policy as data), and what an eviction frees, which
the step backend sums, is then the post-shrink ``alloc``, not ``size``.
Without a resize policy those fields are ``None`` and the step is the
static one.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from . import xp
from .registry import (RESIZE, ResizeCtx, SlotStats, replacement_priority,
                       shrink_amounts)
from .types import DROP, HIT, MISS, Policy, PoolConfig

_INF = float("inf")


class PoolState(NamedTuple):
    """Warm-pool state; every field carries a leading pool axis in the
    batched step (slot arrays ``[P, S]``, scalars ``[P]``)."""

    # per-slot arrays (S = max_slots)
    func_id: torch.Tensor    # i32[S], -1 = empty
    size: torch.Tensor       # f32[S] MB
    last_use: torch.Tensor   # f32[S]
    freq: torch.Tensor       # f32[S]
    gd_pri: torch.Tensor     # f32[S]
    busy_until: torch.Tensor # f32[S]
    seq: torch.Tensor        # f32[S] launch sequence (tie-break)
    valid: torch.Tensor      # bool[S]
    # scalars
    capacity: torch.Tensor   # f32
    free: torch.Tensor       # f32
    clock: torch.Tensor      # f32 GreedyDual inflation clock
    next_seq: torch.Tensor   # f32
    policy: torch.Tensor     # i32 replacement-policy code
    # vertical scaling (all None when resize is off)
    alloc: torch.Tensor | None = None      # f32[S] current limit (MB)
    used: torch.Tensor | None = None       # f32[S] observed usage (MB)
    rz_policy: torch.Tensor | None = None  # i32 resize-policy code
    rz_min: torch.Tensor | None = None     # f32 limit floor (MB)
    acc_used: torch.Tensor | None = None   # f32 used summed over served
    acc_alloc: torch.Tensor | None = None  # f32 alloc summed over served
    bneck: torch.Tensor | None = None      # i32 hits on shrunken residents


#: The dtype of every static field, as the reference keeps it.
STATE_DTYPES = {
    "func_id": torch.int32, "size": torch.float32,
    "last_use": torch.float32, "freq": torch.float32,
    "gd_pri": torch.float32, "busy_until": torch.float32,
    "seq": torch.float32, "valid": torch.bool,
    "capacity": torch.float32, "free": torch.float32,
    "clock": torch.float32, "next_seq": torch.float32,
    "policy": torch.int32,
}
#: The dtype of every vertical-scaling field, as the reference keeps it.
RESIZE_DTYPES = {
    "alloc": torch.float32, "used": torch.float32,
    "rz_policy": torch.int32, "rz_min": torch.float32,
    "acc_used": torch.float32, "acc_alloc": torch.float32,
    "bneck": torch.int32,
}


class Event(NamedTuple):
    """One invocation; 0-d tensors (f32 times and sizes, i32 ids)."""

    t: torch.Tensor
    func_id: torch.Tensor
    size: torch.Tensor
    cls: torch.Tensor
    warm: torch.Tensor
    cold: torch.Tensor
    # observed usage of the launched container (``observed_usage``);
    # None when resize is off
    used: torch.Tensor | None = None


def init_pool(cfg: PoolConfig, device=None) -> PoolState:
    """An empty pool on ``device`` (``None`` means the CUDA device; a
    CPU pool is asked for with ``device="cpu"``)."""
    device = resolve_device(device)
    s = cfg.max_slots
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    rz = {}
    if cfg.resize_policy is not None:
        rz = dict(alloc=torch.zeros(s, **f32), used=torch.zeros(s, **f32),
                  rz_policy=torch.tensor(RESIZE.resolve(cfg.resize_policy),
                                         **i32),
                  rz_min=torch.tensor(cfg.resize_min_mb, **f32),
                  acc_used=torch.tensor(0.0, **f32),
                  acc_alloc=torch.tensor(0.0, **f32),
                  bneck=torch.tensor(0, **i32))
    return PoolState(
        func_id=torch.full((s,), -1, dtype=torch.int32, device=device),
        size=torch.zeros(s, **f32),
        last_use=torch.zeros(s, **f32),
        freq=torch.zeros(s, **f32),
        gd_pri=torch.zeros(s, **f32),
        busy_until=torch.zeros(s, **f32),
        seq=torch.zeros(s, **f32),
        valid=torch.zeros(s, dtype=torch.bool, device=device),
        capacity=torch.tensor(cfg.capacity_mb, **f32),
        free=torch.tensor(cfg.capacity_mb, **f32),
        clock=torch.tensor(0.0, **f32),
        next_seq=torch.tensor(1.0, **f32),
        policy=torch.tensor(int(cfg.policy), dtype=torch.int32,
                            device=device),
        **rz,
    )


def pool_state_from_numpy(fields: Mapping[str, np.ndarray],
                          device) -> PoolState:
    """The port's :class:`PoolState` from a reference state's leaves as
    numpy arrays (``{k: np.asarray(v) for k, v in
    state._asdict().items() if v is not None}``), single or stacked —
    the simulator's equivalent of loading weights.  Each field gets the
    reference's dtype explicitly.  A resize-enabled state brings all
    seven vertical-scaling fields, a static one none of them."""
    fields = {k: v for k, v in fields.items() if v is not None}
    unknown = set(fields) - set(PoolState._fields)
    if unknown:
        raise ValueError(f"not PoolState fields: {sorted(unknown)}")
    dtypes = dict(STATE_DTYPES)
    if any(f in fields for f in RESIZE_DTYPES):
        dtypes.update(RESIZE_DTYPES)
    missing = set(dtypes) - set(fields)
    if missing:
        raise ValueError(f"missing PoolState fields: {sorted(missing)}")
    return PoolState(**{
        k: torch.tensor(np.asarray(fields[k]), dtype=dt, device=device)
        for k, dt in dtypes.items()})


def stack_pools(states) -> PoolState:
    """Stack single-pool states on a new leading pool axis."""
    return PoolState(*(None if xs[0] is None else torch.stack(xs)
                       for xs in zip(*states)))


def _gd(clock, freq, cold_cost, size):
    return clock + freq * cold_cost / torch.clamp_min(size, 1e-6)


def _priority(p: PoolState) -> torch.Tensor:
    """Eviction priority f32[P, S] of every slot (lower = evicted
    first), from the replacement registry with the policy code as data."""
    stats = SlotStats(last_use=p.last_use, freq=p.freq, gd_pri=p.gd_pri,
                      size=p.size, busy_until=p.busy_until)
    return replacement_priority(xp, p.policy.unsqueeze(-1), stats)


def _shrink_pass(p: PoolState, idle: torch.Tensor, want: torch.Tensor):
    """The miss path's vertical-scaling shrink pass over the batched
    ``[P, S]`` layout: the registered resize policy (its code as data)
    proposes limits, :func:`~repro_torch.core.registry.shrink_amounts`
    clamps them, and the pass returns ``(alloc_after f32[P, S],
    reclaimed f32[P])``.  The per-pool scalars enter ``ResizeCtx`` as
    ``[P, 1]`` columns, so the policies' ``axis=-1`` sums line up."""
    def col(x):
        return x.unsqueeze(-1)
    ctx = ResizeCtx(used=p.used, alloc=p.alloc, size=p.size, idle=idle,
                    valid=p.valid, min_mb=col(p.rz_min),
                    deficit=col(torch.clamp_min(want, 0.0)),
                    free=col(p.free), capacity=col(p.capacity))
    shrink = shrink_amounts(xp, col(p.rz_policy), ctx)
    return p.alloc - shrink, shrink.sum(-1)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none), as
    ``jnp.argmax`` of a bool array."""
    return mask.to(torch.uint8).argmax(-1)


def _evict_prefix(pri, seq, sz, idle, deficit):
    """The minimal ``(priority, seq)``-ordered prefix of idle slots whose
    eviction covers ``deficit``: stable sort by ``seq``, then stably by
    ``pri``, and a prefix sum over the freed bytes.  ``pri`` is already
    ``+inf`` on slots that are not idle.  Returns ``(evict bool[P, S],
    freed f32[P])``."""
    by_seq = torch.argsort(seq, dim=-1, stable=True)
    order = by_seq.gather(
        -1, torch.argsort(pri.gather(-1, by_seq), dim=-1, stable=True))
    idle_ord = idle.gather(-1, order)
    sz_ord = torch.where(idle_ord, sz.gather(-1, order), 0.0)
    freed_before = torch.cumsum(sz_ord, -1) - sz_ord
    evict_ord = idle_ord & (freed_before < (deficit - 1e-9).unsqueeze(-1))
    evict = torch.zeros_like(idle).scatter(-1, order, evict_ord)
    freed = torch.where(evict, sz, 0.0).sum(-1)
    return evict, freed


# ---------------------------------------------------------------------------
# Step backends: implementations of the miss-path evict-and-place decision
# over the stacked [pools, slots] axes.  The contract, as the reference's:
#
#   backend(pri f32[P,S], seq f32[P,S], size f32[P,S], idle bool[P,S],
#           valid bool[P,S], deficit f32[P])
#       -> (evict bool[P,S], freed f32[P], ins i32[P],
#           avail f32[P], empty_exists bool[P])
#
# ``pri`` is +inf on slots that are not idle, ``size`` is the bytes an
# eviction frees, ``deficit`` the bytes that must be freed (may be <= 0);
# ``evict`` is the minimal (priority, seq)-ordered idle prefix covering
# the deficit, ``freed``/``avail`` the evicted / all evictable bytes, and
# ``ins``/``empty_exists`` locate the first slot empty after eviction.
# Every backend is bitwise equal to ``_evict_place_lax``.
_STEP_BACKENDS: dict = {}


def register_step_backend(name: str):
    """Register a miss-path evict-and-place backend (see the contract)."""
    def deco(fn):
        if name in _STEP_BACKENDS:
            raise ValueError(f"step backend {name!r} already registered")
        _STEP_BACKENDS[name] = fn
        return fn
    return deco


def step_backends() -> tuple[str, ...]:
    """Names of the registered step backends."""
    get_step_backend("fused")   # make sure the lazy default is in
    return tuple(_STEP_BACKENDS)


def get_step_backend(name: str):
    """Resolve a backend by name; ``"fused"`` imports the kernel module
    on first use (kernels -> core is the only import direction)."""
    if name not in _STEP_BACKENDS and name == "fused":
        from ..kernels import pool_step as _  # noqa: F401  (registers)
    try:
        return _STEP_BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown step backend {name!r}; registered: "
                         f"{tuple(_STEP_BACKENDS)}") from None


@register_step_backend("lax")
def _evict_place_lax(pri, seq, size, idle, valid, deficit):
    """Reference backend: the sort composite of ``_evict_prefix``."""
    evict, freed = _evict_prefix(pri, seq, size, idle, deficit)
    avail = torch.where(idle, size, 0.0).sum(-1)
    empty = ~(valid & ~evict)
    return (evict, freed, _first_true(empty).to(torch.int32), avail,
            empty.any(-1))


def _select(mask: torch.Tensor, new, old):
    """``where(mask, new, old)`` with ``mask`` over the leading pool
    axis; a field a branch left untouched is passed through as is."""
    if new is old:
        return old
    return torch.where(mask.view(mask.shape + (1,) * (old.ndim - 1)),
                       new, old)


def pool_step_batch(p: PoolState, ev: Event, evict_place):
    """Process one invocation against every stacked pool at once.

    ``p`` carries a leading pool axis ``P`` on every field; the outcome
    (hit / miss / drop) and new state are computed for every pool
    against the same event, and the caller keeps the rows it routed to.
    The miss path's evict-and-place decision is delegated to
    ``evict_place`` (a registered step backend).  With resize on, a miss
    first runs the shrink pass, and the backend's byte column is the
    post-shrink ``alloc`` (what an eviction frees; the eviction order
    never reads it).  Returns ``(new_state, outcome i32[P])``."""
    rz = p.alloc is not None
    slots = torch.arange(p.func_id.shape[-1], device=p.func_id.device)
    idle = p.valid & (p.busy_until <= ev.t)          # [P, S]
    match = idle & (p.func_id == ev.func_id)
    any_hit = match.any(-1)                          # [P]
    cold_cost = ev.cold - ev.warm

    # ---- HIT branch: touch the matching idle container with lowest seq ----
    hit_slot = torch.where(match, p.seq, _INF).argmin(-1, keepdim=True)
    hit_oh = slots == hit_slot                       # [P, S]
    new_freq = p.freq.gather(-1, hit_slot) + 1.0     # [P, 1]
    hit_size = p.size.gather(-1, hit_slot)           # [P, 1]
    hit_extra = {}
    if rz:
        hit_alloc = p.alloc.gather(-1, hit_slot)
        hit_extra = dict(
            acc_used=p.acc_used + p.used.gather(-1, hit_slot).squeeze(-1),
            acc_alloc=p.acc_alloc + hit_alloc.squeeze(-1),
            # a resident serving from a shrunken limit is a bottleneck
            bneck=p.bneck + (hit_alloc < hit_size).squeeze(-1).to(
                torch.int32))
    hit_state = p._replace(
        last_use=torch.where(hit_oh, ev.t, p.last_use),
        freq=torch.where(hit_oh, new_freq, p.freq),
        gd_pri=torch.where(
            hit_oh, _gd(p.clock.unsqueeze(-1), new_freq, cold_cost,
                        hit_size), p.gd_pri),
        busy_until=torch.where(hit_oh, ev.t + ev.warm, p.busy_until),
        **hit_extra,
    )

    # ---- MISS branch: shrink idle residents (resize only), then the
    # backend evicts the (priority, seq)-prefix, then the new container
    # goes into the first empty slot ------------------------------------
    if rz:
        alloc1, reclaimed = _shrink_pass(p, idle, ev.size - p.free)
        free1 = p.free + reclaimed
    else:
        alloc1, free1 = p.size, p.free
    deficit = ev.size - free1                        # [P]
    pri = torch.where(idle, _priority(p), _INF)
    evict, freed, ins, avail, empty_exists = evict_place(
        pri, p.seq, alloc1, idle, p.valid, deficit)

    can_place = ((ev.size <= p.capacity + 1e-9)
                 & (avail >= deficit - 1e-9)
                 & empty_exists)
    is_gd = p.policy == int(Policy.GREEDY_DUAL)
    # with no eviction the inner max is -inf and maximum() keeps p.clock
    new_clock = torch.where(
        is_gd,
        torch.maximum(p.clock,
                      torch.where(evict, p.gd_pri, -_INF).amax(-1)),
        p.clock)
    ins_oh = slots == ins.unsqueeze(-1)              # [P, S]
    miss_extra = {}
    if rz:
        miss_extra = dict(
            alloc=torch.where(ins_oh, ev.size,
                              torch.where(evict, 0.0, alloc1)),
            used=torch.where(ins_oh, ev.used,
                             torch.where(evict, 0.0, p.used)),
            acc_used=p.acc_used + ev.used,
            acc_alloc=p.acc_alloc + ev.size)
    miss_state = p._replace(
        func_id=torch.where(ins_oh, ev.func_id, p.func_id),
        size=torch.where(ins_oh, ev.size, p.size),
        last_use=torch.where(ins_oh, ev.t, p.last_use),
        freq=torch.where(ins_oh, 1.0, p.freq),
        gd_pri=torch.where(
            ins_oh, _gd(new_clock.unsqueeze(-1), 1.0, cold_cost, ev.size),
            p.gd_pri),
        busy_until=torch.where(ins_oh, ev.t + ev.cold, p.busy_until),
        seq=torch.where(ins_oh, p.next_seq.unsqueeze(-1), p.seq),
        valid=(p.valid & ~evict) | ins_oh,
        free=free1 + freed - ev.size,
        clock=new_clock,
        next_seq=p.next_seq + 1.0,
        **miss_extra,
    )

    # ---- select ----
    outcome = torch.where(any_hit, HIT,
                          torch.where(can_place, MISS, DROP)
                          ).to(torch.int32)          # [P]
    is_hit, is_miss = outcome == HIT, outcome == MISS
    new_state = PoolState(*(
        _select(is_miss, m, _select(is_hit, h, d))
        for h, m, d in zip(hit_state, miss_state, p)))
    return new_state, outcome


def pool_step(p: PoolState, ev: Event):
    """Process one invocation against one pool (unbatched fields).
    Returns ``(new_state, outcome i32)``; the one-pool case of
    :func:`pool_step_batch` with the ``"lax"`` backend."""
    one = PoolState(*(None if a is None else a.unsqueeze(0) for a in p))
    new, outcome = pool_step_batch(one, ev, _evict_place_lax)
    return (PoolState(*(None if a is None else a.squeeze(0) for a in new)),
            outcome.squeeze(0))


def pool_resize(p: PoolState, now: torch.Tensor,
                new_capacity: torch.Tensor) -> PoolState:
    """Change every stacked pool's capacity between autoscaler epochs
    (the reference's ``pool_resize``, vmapped over the pool axis).

    Evicts the lowest-``(priority, seq)`` *idle* prefix until the new
    capacity (f32[P]) is respected; busy containers are never killed, so
    a hard shrink can leave ``free`` negative, which blocks admissions
    until they drain.  Unlike the miss path, the eviction does not move
    the GreedyDual clock.  ``now`` (a 0-d tensor) is the epoch's last
    event time.  With resize on, a resident holds (and an eviction
    frees) its ``alloc``, and an evicted slot's ``alloc``/``used`` are
    zeroed."""
    rz = p.alloc is not None
    held = p.alloc if rz else p.size                 # what eviction frees
    used = torch.where(p.valid, held, 0.0).sum(-1)            # [P]
    idle = p.valid & (p.busy_until <= now)
    evict, freed = _evict_prefix(torch.where(idle, _priority(p), _INF),
                                 p.seq, held, idle, used - new_capacity)
    extra = {} if not rz else dict(alloc=torch.where(evict, 0.0, p.alloc),
                                   used=torch.where(evict, 0.0, p.used))
    return p._replace(valid=p.valid & ~evict, capacity=new_capacity,
                      free=new_capacity - (used - freed), **extra)
