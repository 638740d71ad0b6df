"""Edge-cloud continuum: the cluster config and its host-side numpy data.

The parts of ``repro.core.continuum`` the static cluster path needs,
copied byte for byte because they are shared verbatim with the
reference: ``ClusterConfig`` (with ``pool_caps``), the routing hashes,
the pre-drawn cloud cold-start coins, the end-to-end pricing, the
failure schedule (``Failures``, compiled on the host into per-event
masks), the autoscaler's knob (``Autoscale``) and the chain plan
(``ChainPlan``, ``compile_chains``); then the numpy oracle
(``cluster_outcomes_ref``), one event at a time over
:class:`~repro_torch.core.pool_ref.WarmPool`, which ``simulate(...,
engine="ref")`` runs, and the historical ``ContinuumConfig`` /
``simulate_continuum``.  The oracle calls each routing policy's body
with ``np`` and 1-D numpy ctx arrays (the bodies are written in numpy's
spelling), and mirrors every float32 step of the engine, so the two give
identical arrays.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as np

from .compat import deprecated
from .pool_ref import WarmPool
from .registry import REPLACEMENT, RESIZE, ROUTING, RouteCtx
from .types import (DROP, HIT, MISS, ClassMetrics, Policy, PoolConfig,
                    Trace)

_OUT_CODE = {"hit": HIT, "miss": MISS, "drop": DROP}


class RoutingPolicy(enum.IntEnum):
    """The built-in routing policies' registry codes, as an enum."""

    STICKY = 0
    LEAST_LOADED = 1
    SIZE_AWARE = 2
    POWER_OF_TWO = 3


# the registry is the source of truth; the enums are frozen aliases of
# its first entries and must never drift from it
if [r.name.lower() for r in RoutingPolicy] != ROUTING.names()[:4]:
    raise RuntimeError("RoutingPolicy drifted from the routing registry")
if [p.name.lower() for p in Policy] != REPLACEMENT.names()[:3]:
    raise RuntimeError("Policy drifted from the replacement registry")


@dataclasses.dataclass(frozen=True)
class Autoscale:
    """Per-epoch adaptive re-splitting of every KiSS node's pools.

    Every ``epoch_events`` invocations, each non-unified node re-tunes its
    small/large split from the *observed per-class pressure* on that node
    (misses + 2x drops), moving the split ``gain`` of the way toward the
    pressured class and clipping to ``[min_frac, max_frac]``.  Shrinking a
    pool evicts lowest-priority idle containers; busy containers are never
    killed (the pool temporarily runs a negative free balance).

    A trailing partial epoch never completes, so it triggers no re-split
    (the port runs it unpadded; the reference pads it with guaranteed-drop
    events that this rule keeps out of the pressure signal).

    **Node add/remove** (``spawn_drop_frac`` set): the autoscaler also
    carries a per-node *active* mask.  A full epoch whose cluster-wide
    drop fraction exceeds ``spawn_drop_frac`` spawns the lowest-index
    inactive node (empty pools — it joins cold); one whose drop fraction
    falls below ``retire_drop_frac`` retires the emptiest active node
    (lowest resident MB; its residents are invalidated, counted in the
    ``invalidated`` metric).  At most one node moves per epoch and the
    cluster never shrinks below one active node.  ``init_active`` starts
    only the first k nodes (default: all).  Inactive nodes are invisible
    to routing (``RouteCtx.node_up``) and requests a mask-blind policy
    still sends there drop to the cloud.

    Frozen and hashable: rides inside :class:`repro_torch.sim.Scenario`;
    ``min_frac``/``max_frac``/``gain`` and the spawn/retire thresholds
    reach the engine as data (a device tensor), not as Python constants.
    """

    epoch_events: int = 512
    min_frac: float = 0.5
    max_frac: float = 0.9
    gain: float = 0.15   # fraction step per epoch toward the pressured class
    # -- node add/remove (None = fixed membership) -------------------------
    spawn_drop_frac: float | None = None  # spawn when epoch drop frac >
    retire_drop_frac: float = 0.0         # retire emptiest when drop frac <
    init_active: int | None = None        # start with the first k nodes only

    def __post_init__(self):
        if int(self.epoch_events) != self.epoch_events or \
                self.epoch_events < 1:
            raise ValueError("epoch_events must be a positive integer")
        object.__setattr__(self, "epoch_events", int(self.epoch_events))
        if not 0.0 < self.min_frac <= self.max_frac < 1.0:
            raise ValueError("need 0 < min_frac <= max_frac < 1")
        if self.gain < 0.0:
            raise ValueError("gain must be >= 0")
        if self.spawn_drop_frac is None:
            if self.retire_drop_frac != 0.0 or self.init_active is not None:
                raise ValueError(
                    "retire_drop_frac/init_active require node scaling — "
                    "set spawn_drop_frac to enable it")
        else:
            if not 0.0 < self.spawn_drop_frac <= 1.0:
                raise ValueError("spawn_drop_frac must be in (0, 1]")
            if not 0.0 <= self.retire_drop_frac < self.spawn_drop_frac:
                raise ValueError(
                    "need 0 <= retire_drop_frac < spawn_drop_frac")
            if self.init_active is not None:
                if int(self.init_active) != self.init_active or \
                        self.init_active < 1:
                    raise ValueError("init_active must be a positive "
                                     "integer (or None for all nodes)")
                object.__setattr__(self, "init_active",
                                   int(self.init_active))

    @property
    def node_scaled(self) -> bool:
        """Whether this autoscaler also spawns/retires whole nodes."""
        return self.spawn_drop_frac is not None


@dataclasses.dataclass(frozen=True)
class Failures:
    """A node-failure schedule: ``(t_down, t_up, node)`` outage windows.

    A node is *down* for every event with ``t_down <= t < t_up``: its
    pools are frozen, routing sees it masked out of ``RouteCtx.node_up``,
    and a request still routed to it drops to the cloud.  At the first
    event at or after ``t_up`` the node recovers with empty pools (its
    residents are invalidated), so the metrics show the re-warm cost.
    :meth:`masks` compiles the schedule on the host; the engine reads the
    masks as data.  Frozen and hashable: it rides inside a ``Scenario``.
    """

    windows: tuple[tuple[float, float, int], ...]

    def __post_init__(self):
        wins = []
        for w in self.windows:
            if len(w) != 3:
                raise ValueError(
                    f"each failure window must be (t_down, t_up, node), "
                    f"got {w!r}")
            t_down, t_up, node = float(w[0]), float(w[1]), int(w[2])
            if not t_down < t_up:
                raise ValueError(
                    f"failure window needs t_down < t_up, got {w!r}")
            if node < 0:
                raise ValueError(f"failure window node must be >= 0: {w!r}")
            wins.append((t_down, t_up, node))
        if not wins:
            raise ValueError("Failures needs at least one window")
        object.__setattr__(self, "windows", tuple(wins))

    @property
    def max_node(self) -> int:
        return max(n for _, _, n in self.windows)

    def masks(self, t: np.ndarray, n_nodes: int):
        """Compile the schedule against the sorted event times ``t``.

        Returns ``(up, recover)``, both bool[T, N]: ``up[i, n]`` is whether
        node ``n`` is live at event ``i``; ``recover[i, n]`` marks the first
        event at or after an outage's end, before which the node's pools
        are cleared.  A window between two events still clears (the node
        did die), and overlapping windows clear once, when the node is
        back up."""
        t = np.asarray(t)
        up = np.ones((len(t), n_nodes), bool)
        recover = np.zeros((len(t), n_nodes), bool)
        for t_down, t_up, node in self.windows:
            if node >= n_nodes:
                raise ValueError(
                    f"failure window node {node} out of range for "
                    f"{n_nodes} nodes")
            up[(t >= t_down) & (t < t_up), node] = False
            after = np.nonzero(t >= t_up)[0]
            if len(after):
                recover[after[0], node] = True
        return up, recover & up


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """A heterogeneous edge cluster in front of a priced cloud tier.

    Per-node tuples: ``node_mb`` (warm-pool memory), ``small_frac`` (KiSS
    split, ignored when unified) and ``unified`` (True = one pool).
    Every node materializes two pools — a unified node gets ``(node_mb,
    0)`` and routes both classes to pool 0 — so all pools of the cluster
    stack on one leading axis.  ``resize_policy`` (a registered resize
    policy's name or code; ``None`` turns vertical scaling off) and
    ``resize_min_mb`` configure every pool's shrink pass.
    """

    node_mb: tuple[float, ...]
    small_frac: tuple[float, ...]
    unified: tuple[bool, ...]
    policy: Policy | int | str = Policy.LRU
    routing: RoutingPolicy | int | str = RoutingPolicy.STICKY
    cloud_rtt_s: float = 0.25         # edge->cloud round trip
    cloud_cold_prob: float = 0.05     # cloud has big warm pools
    max_slots: int = 1024             # per-pool slot count
    # vertical scaling: a registered resize policy (name | code) shrinks
    # residents toward observed usage under pressure before evicting
    resize_policy: int | str | None = None
    resize_min_mb: float = 0.0

    def __post_init__(self):
        n = len(self.node_mb)
        if not (len(self.small_frac) == len(self.unified) == n and n > 0):
            raise ValueError("node_mb/small_frac/unified must align, n>=1")
        rcode = ROUTING.resolve(self.routing)
        object.__setattr__(
            self, "routing",
            RoutingPolicy(rcode) if rcode < len(RoutingPolicy) else rcode)
        pcode = REPLACEMENT.resolve(self.policy)
        object.__setattr__(
            self, "policy", Policy(pcode) if pcode < len(Policy) else pcode)
        if self.resize_policy is not None:
            object.__setattr__(self, "resize_policy",
                               RESIZE.resolve(self.resize_policy))
        if self.resize_min_mb < 0.0:
            raise ValueError("resize_min_mb must be >= 0")

    @property
    def n_nodes(self) -> int:
        return len(self.node_mb)

    @classmethod
    def homogeneous(cls, n_nodes: int, node_mb: float, *, kiss: bool = True,
                    small_frac: float = 0.8, **kw) -> "ClusterConfig":
        """``n_nodes`` identical nodes of ``node_mb``: KiSS-split at
        ``small_frac`` (``kiss=True``) or unified."""
        return cls(node_mb=(float(node_mb),) * n_nodes,
                   small_frac=(float(small_frac),) * n_nodes,
                   unified=(not kiss,) * n_nodes, **kw)

    def pool_caps(self) -> np.ndarray:
        """f64[N, 2] per-node (small, large) pool capacities in MB,
        rounded through float32 as the reference rounds them."""
        caps = np.zeros((self.n_nodes, 2), np.float64)
        for n in range(self.n_nodes):
            if self.unified[n]:
                caps[n] = (self.node_mb[n], 0.0)
            else:
                caps[n] = (self.node_mb[n] * self.small_frac[n],
                           self.node_mb[n] * (1.0 - self.small_frac[n]))
        return np.float32(caps).astype(np.float64)


def route_hashes(func_id: np.ndarray, n_nodes: int):
    """Two deterministic node hashes per event: ``h1 = func_id % n_nodes``
    (sticky) and ``h2`` a Knuth multiplicative hash."""
    fid = np.asarray(func_id)
    h1 = (fid % n_nodes).astype(np.int32)
    mixed = (fid.astype(np.uint32) * np.uint32(2654435761)) >> np.uint32(16)
    h2 = (mixed % np.uint32(n_nodes)).astype(np.int32)
    return h1, h2


def cloud_cold_draws(n: int, prob: float, rng_seed: int = 0) -> np.ndarray:
    """Pre-drawn cloud cold-start coin flips (common random numbers)."""
    return np.random.default_rng(rng_seed).random(n) < prob


def continuum_latencies(trace: Trace, outcome: np.ndarray,
                        cloud_cold: np.ndarray,
                        cloud_rtt_s: float) -> np.ndarray:
    """Price each outcome end-to-end: hit -> warm, miss -> cold, drop ->
    RTT + cloud execution (cold with the pre-drawn probability)."""
    warm = np.asarray(trace.warm_dur, np.float64)
    cold = np.asarray(trace.cold_dur, np.float64)
    return np.where(outcome == HIT, warm,
                    np.where(outcome == MISS, cold,
                             cloud_rtt_s + np.where(cloud_cold, cold, warm)))


# --------------------------------------------------------------------------
# function chains: the host-compiled plan (the reference's, copied)
# --------------------------------------------------------------------------

class ChainPlan(NamedTuple):
    """Chain accounting data compiled host-side from a chained ``Trace``.

    Per-event arrays index the *dense* chain rows ``0..n_chains-1``
    (``chain_id`` values are mapped through ``np.unique``).  ``deadline``
    carries the reference's junk row appended (``+inf``), which the
    reference's pad events index; the port pads no event, so its engine
    reads rows ``0..n_chains-1`` only.  The arrays are the reference's
    byte for byte (copied, as is :func:`compile_chains`).
    """

    cid: np.ndarray       # i32[T] dense chain row per event
    stage: np.ndarray     # i32[T] 0-based stage within the chain
    last: np.ndarray      # bool[T] event is its chain's final stage
    deadline: np.ndarray  # f32[C+1] per-chain deadline incl. junk row
    n_chains: int


def compile_chains(trace: Trace, deadline_s: float | None = None,
                   slack: float | None = None) -> ChainPlan:
    """Compile a chained trace into a :class:`ChainPlan`.

    ``deadline_s`` is an absolute per-chain deadline in seconds;
    ``slack`` instead derives each chain's deadline as ``slack x`` the
    chain's warm-duration sum (the all-warm critical path, accumulated
    in float32 as the reference does, so the deadline's last bit is
    the reference's).
    With neither, deadlines are ``+inf``: chains are tracked (latency,
    drops) but can only miss by dropping a stage — never by time.
    """
    if not trace.has_chains:
        raise ValueError("compile_chains needs a chained trace "
                         "(Trace.chain_id/stage/chain_len set) — "
                         "e.g. repro_torch.workloads.chained_trace")
    if deadline_s is not None and slack is not None:
        raise ValueError("pass deadline_s or slack, not both")
    uniq, inv = np.unique(np.asarray(trace.chain_id), return_inverse=True)
    n_chains = len(uniq)
    cid = inv.astype(np.int32)
    stage = np.asarray(trace.stage, np.int32)
    last = stage == np.asarray(trace.chain_len, np.int32) - 1
    if deadline_s is not None:
        dl = np.full(n_chains, np.float32(deadline_s), np.float32)
    elif slack is not None:
        warm_sum = np.zeros(n_chains, np.float32)
        np.add.at(warm_sum, cid, np.asarray(trace.warm_dur, np.float32))
        dl = (np.float32(slack) * warm_sum).astype(np.float32)
    else:
        dl = np.full(n_chains, np.inf, np.float32)
    deadline = np.concatenate([dl, np.full(1, np.inf, np.float32)])
    return ChainPlan(cid=cid, stage=stage, last=last, deadline=deadline,
                     n_chains=n_chains)


# --------------------------------------------------------------------------
# the numpy oracle: one event at a time over WarmPool
# --------------------------------------------------------------------------

def _tel_acc_ref(n_windows: int, n_nodes: int) -> dict:
    """Zeroed window arrays for the oracle's telemetry mirror — the same
    schema the engine's ``_tel_np`` emits (``repro_torch.sim.telemetry``
    documents the fields)."""
    return {"counts": np.zeros((n_windows, 2, 3), np.int64),
            "free_mb": np.zeros((n_windows, n_nodes), np.float32),
            "occupancy": np.zeros((n_windows, n_nodes), np.int64),
            "invalidated": np.zeros(n_windows, np.int64),
            "nodes_up": np.zeros(n_windows, np.int64),
            "nodes_active": np.zeros(n_windows, np.int64),
            "chain_miss": np.zeros(n_windows, np.int64)}


def cluster_outcomes_ref(cfg: ClusterConfig, trace: Trace,
                         autoscale: Autoscale | None = None,
                         failures: "Failures | None" = None,
                         telemetry: int | None = None,
                         chains: ChainPlan | None = None,
                         chain_cold: np.ndarray | None = None):
    """Sequential oracle for the cluster: returns ``(node, outcome)`` as
    i32[T] arrays (outcome: 0 hit, 1 miss, 2 drop/offload).  With
    ``failures`` an *extras* dict is appended; with ``autoscale`` a
    per-epoch ``fracs`` f32[E, N] array and the extras dict are appended
    (``(node, outcome, fracs, extras)``).  ``extras`` carries
    ``invalidated`` (i64[N] residents killed by recovery/retirement),
    ``node_up`` (the compiled bool[T, N] failure mask, or None) and — on
    the autoscaled path — ``active`` (bool[E, N] membership trajectory).

    ``telemetry`` (a window length in events) additionally accumulates
    per-window counters into ``extras["telemetry"]`` — counter updates
    are exact integers on the emitted outcomes and the ``free_mb``
    snapshot goes through float32 step for step, so the window arrays are
    *bit-identical* to the torch engine's window arrays (a plain run
    with telemetry returns ``(node, outcome, extras)``).

    ``chains`` (a :class:`ChainPlan`) threads per-chain accounting
    through the event loop — accumulated end-to-end latency, dropped /
    done / missed flags, with each stage priced hit -> warm, miss ->
    cold, drop -> RTT + cloud (using the pre-drawn ``chain_cold`` coin
    flips, the same ``cloud_cold_draws`` array the host pricing uses) —
    every scalar through float32 in event order, mirroring the torch
    engine's chain accumulator bit for bit.  Routing policies see the
    pre-step remaining slack and stage via ``RouteCtx.chain_slack`` /
    ``chain_stage``.  Results land in ``extras["chains"]`` (a plain run
    with chains returns ``(node, outcome, extras)``); with telemetry the
    window arrays additionally count per-window deadline misses.

    With a configured ``cfg.resize_policy`` (vertical scaling) the run
    always returns an extras dict carrying ``extras["vertical"]``:
    per-pool ``acc_used_mb``/``acc_alloc_mb``/``bottlenecks`` totals in
    the engine's stacked node-major ``[2N]`` pool layout, every f32
    accumulation mirrored step for step.

    The routing decision calls the registered policy function with numpy
    float32 inputs — the same pure function the torch engine runs — so
    any policy added via ``@register_routing`` runs here unchanged.  With
    ``autoscale``, every full epoch of ``epoch_events`` invocations ends by
    re-splitting each KiSS node from its observed per-class pressure
    (``WarmPool.resize``) and — when node scaling is on — spawning or
    retiring one node from the cluster-wide drop fraction, with every
    scalar step mirrored through float32 so the torch engine's decisions
    are reproduced bit-for-bit.
    """
    n = cfg.n_nodes
    caps = cfg.pool_caps()
    rz_on = cfg.resize_policy is not None
    pools = [[WarmPool(PoolConfig(caps[i, k], cfg.policy, cfg.max_slots,
                                  resize_policy=cfg.resize_policy,
                                  resize_min_mb=cfg.resize_min_mb))
              for k in (0, 1)] for i in range(n)]

    def _vertical() -> dict:
        """Per-pool vertical-scaling totals in the engine's stacked
        ``[2N]`` (node-major) pool layout — f32 values bit-identical to
        the torch engine's accumulators."""
        flat = [pools[j][k] for j in range(n) for k in (0, 1)]
        return {"acc_used_mb": np.array(
                    [np.float32(p.acc_used) for p in flat], np.float32),
                "acc_alloc_mb": np.array(
                    [np.float32(p.acc_alloc) for p in flat], np.float32),
                "bottlenecks": np.array(
                    [p.bneck for p in flat], np.int64)}
    h1, h2 = route_hashes(trace.func_id, n)
    unified = np.asarray(cfg.unified, bool)
    cap_f32 = caps.astype(np.float32)
    nodes_idx = np.arange(n)
    sink = ClassMetrics()   # per-node metrics are derived from the outputs
    node_out = np.empty(len(trace), np.int32)
    outcome_out = np.empty(len(trace), np.int32)
    # routing inputs precomputed per size class (loop-invariant between
    # re-splits; refreshed by the autoscaler below when capacities move)
    tgt_by_cls = [np.where(unified, 0, c) for c in (0, 1)]
    cap_by_cls = [cap_f32[nodes_idx, t] for t in tgt_by_cls]
    spec = ROUTING.spec(cfg.routing)
    rtt = np.float32(cfg.cloud_rtt_s)
    ccp = np.float32(cfg.cloud_cold_prob)
    up_mask = recover = None
    if failures is not None:
        up_mask, recover = failures.masks(trace.t, n)
    all_up = np.ones(n, bool)
    invalidated = np.zeros(n, np.int64)
    tel = None
    inv_seen = 0
    if telemetry is not None:
        tel = _tel_acc_ref(-(-len(trace) // telemetry), n)
    # chain accounting twin: one f32 latency row per chain + a junk row,
    # every update through float32 in event order (see ChainPlan)
    no_slack, no_stage = np.float32(np.inf), np.int32(-1)
    if chains is not None:
        if chain_cold is None:
            raise ValueError("chains accounting needs the pre-drawn "
                             "chain_cold array (cloud_cold_draws)")
        ch_lat = np.zeros(chains.n_chains + 1, np.float32)
        ch_dropped = np.zeros(chains.n_chains + 1, bool)
        ch_done = np.zeros(chains.n_chains + 1, bool)
        ch_missed = np.zeros(chains.n_chains + 1, bool)

    def tel_event(i: int, up_cnt: int, act_cnt: int) -> None:
        """Mirror of the engine's ``_tel_event``: scatter-add the counts,
        last-write-win the window-end snapshots (``free_mb`` as one f32
        add per node, exactly like ``pools.free.reshape(n, 2).sum``)."""
        nonlocal inv_seen
        w = i // telemetry
        tel["counts"][w, int(trace.cls[i]), int(outcome_out[i])] += 1
        for j in range(n):
            tel["free_mb"][w, j] = (np.float32(pools[j][0].free_mb)
                                    + np.float32(pools[j][1].free_mb))
            tel["occupancy"][w, j] = (len(pools[j][0].containers)
                                      + len(pools[j][1].containers))
        tot = int(invalidated.sum())
        tel["invalidated"][w] += tot - inv_seen
        inv_seen = tot
        tel["nodes_up"][w] = up_cnt
        tel["nodes_active"][w] = act_cnt

    def run_event(i: int, eff_up: np.ndarray) -> tuple[int, int]:
        # recovery first: a node coming back up re-joins with empty pools
        if recover is not None and recover[i].any():
            for j in np.nonzero(recover[i])[0]:
                invalidated[j] += (pools[j][0].invalidate()
                                   + pools[j][1].invalidate())
        cls = int(trace.cls[i])
        tgt = tgt_by_cls[cls]
        # only load-sensitive policies read pool occupancy; skip the
        # O(n_nodes) per-event scan for the others (spec.needs_free)
        free_t = np.fromiter(
            (pools[j][tgt[j]].free_mb for j in range(n)), np.float32,
            n) if spec.needs_free else None
        if chains is not None:
            row = int(chains.cid[i])
            cslack = np.float32(chains.deadline[row] - ch_lat[row])
            cstage = np.int32(chains.stage[i])
        else:
            cslack, cstage = no_slack, no_stage
        ctx = RouteCtx(
            h1=np.int32(h1[i]), h2=np.int32(h2[i]),
            size=np.float32(trace.size_mb[i]), cls=np.int32(cls),
            warm=np.float32(trace.warm_dur[i]),
            cold=np.float32(trace.cold_dur[i]),
            free=free_t, cap=cap_by_cls[cls],
            cloud_rtt_s=rtt, cloud_cold_prob=ccp, node_up=eff_up,
            chain_slack=cslack, chain_stage=cstage)
        node = int(spec.fn(np, ctx))
        if eff_up[node]:
            out = _OUT_CODE[pools[node][int(tgt[node])].access(
                float(trace.t[i]), int(trace.func_id[i]),
                float(trace.size_mb[i]),
                float(trace.warm_dur[i]), float(trace.cold_dur[i]), sink)]
        else:
            out = DROP          # routed to a dead node: offload, pools
        node_out[i] = node      # untouched (they are frozen/absent)
        outcome_out[i] = out
        if chains is not None:
            # mirror of the engine's _chain_event: stage price in f32,
            # accumulate, flag done/missed at the chain's final stage
            w32 = np.float32(trace.warm_dur[i])
            c32 = np.float32(trace.cold_dur[i])
            if out == HIT:
                stage_lat = w32
            elif out == MISS:
                stage_lat = c32
            else:
                stage_lat = np.float32(rtt + (c32 if chain_cold[i] else w32))
            fin = np.float32(ch_lat[row] + stage_lat)
            ch_lat[row] = fin
            ch_dropped[row] = bool(ch_dropped[row]) or out == DROP
            if chains.last[i]:
                ch_done[row] = True
                miss = bool(ch_dropped[row]) or bool(
                    fin > chains.deadline[row])
                ch_missed[row] = bool(ch_missed[row]) or miss
                if tel is not None and miss:
                    tel["chain_miss"][i // telemetry] += 1
        return node, out

    def chain_np() -> dict:
        """Junk row sliced off — the engine's ``_chain_np`` twin."""
        c = chains.n_chains
        return {"latency": ch_lat[:c].copy(),
                "dropped": ch_dropped[:c].copy(),
                "done": ch_done[:c].copy(),
                "missed": ch_missed[:c].copy()}

    if autoscale is None:
        for i in range(len(trace)):
            eu = all_up if up_mask is None else up_mask[i]
            run_event(i, eu)
            if tel is not None:
                tel_event(i, int(eu.sum()) if up_mask is not None else n, n)
        if failures is None and tel is None and chains is None \
                and not rz_on:
            return node_out, outcome_out
        extras = {} if tel is None else {"telemetry": tel}
        if failures is not None:
            extras.update(invalidated=invalidated, node_up=up_mask)
        if chains is not None:
            extras["chains"] = chain_np()
        if rz_on:
            extras["vertical"] = _vertical()
        return node_out, outcome_out, extras

    # -- autoscaled path: epoch loop with float32-mirrored re-splitting ----
    f32 = np.float32
    e = autoscale.epoch_events
    mn, mx, gain = (f32(autoscale.min_frac), f32(autoscale.max_frac),
                    f32(autoscale.gain))
    # node-scaling thresholds as data: +/-inf when disabled, so the same
    # decision arithmetic runs (and never fires) — mirroring the engine
    scaled = autoscale.node_scaled
    spawn_th = f32(autoscale.spawn_drop_frac) if scaled else f32(np.inf)
    retire_th = f32(autoscale.retire_drop_frac) if scaled else f32(-np.inf)
    active = np.zeros(n, bool)
    active[:autoscale.init_active if autoscale.init_active is not None
           else n] = True
    frac = np.asarray(cfg.small_frac, np.float32)
    node_mb = np.asarray(cfg.node_mb, np.float32)
    press = np.zeros((n, 2), np.float32)   # exact small-integer counts
    dropw = 0
    fracs_out: list[np.ndarray] = []
    actives_out: list[np.ndarray] = []
    for i in range(len(trace)):
        eff = (active if up_mask is None
               else up_mask[i] & active)
        node, out = run_event(i, eff)
        if out == MISS:
            press[node, int(trace.cls[i])] += 1.0
        elif out == DROP:
            press[node, int(trace.cls[i])] += 2.0
            dropw += 1
        if tel is not None:
            tel_event(i, n if up_mask is None else int(up_mask[i].sum()),
                      int(active.sum()))
        if (i + 1) % e:
            continue
        # full epoch boundary: pressure -> split delta -> resize, every
        # scalar op through f32 exactly as the torch engine computes it
        press_s, press_l = press[:, 0], press[:, 1]
        tot = press_s + press_l
        delta = np.where(tot > 0,
                         gain * (press_s - press_l)
                         / np.where(tot > 0, tot, f32(1.0)), f32(0.0))
        cand = np.minimum(mx, np.maximum(frac + delta, mn))
        frac = np.where(unified, frac, cand).astype(np.float32)
        cap_s = node_mb * frac
        cap_l = node_mb * (f32(1.0) - frac)
        now = float(trace.t[i])
        for j in range(n):
            if unified[j]:
                continue
            pools[j][0].resize(now, float(cap_s[j]))
            pools[j][1].resize(now, float(cap_l[j]))
            cap_f32[j, 0], cap_f32[j, 1] = cap_s[j], cap_l[j]
        cap_by_cls = [cap_f32[nodes_idx, t] for t in tgt_by_cls]
        # node add/remove from the cluster-wide drop fraction (post-resize
        # residency decides "emptiest"; at most one node moves per epoch)
        drop_frac = f32(dropw) / np.maximum(f32(e), f32(1.0))
        n_active = int(active.sum())
        if drop_frac > spawn_th and n_active < n:
            active[int(np.argmax(~active))] = True
        elif drop_frac < retire_th and n_active > 1:
            used_n = np.array(
                [f32(cap_f32[j, 0] - f32(pools[j][0].free_mb))
                 + f32(cap_f32[j, 1] - f32(pools[j][1].free_mb))
                 for j in range(n)], np.float32)
            j = int(np.argmin(np.where(active, used_n, f32(np.inf))))
            active[j] = False
            invalidated[j] += (pools[j][0].invalidate()
                               + pools[j][1].invalidate())
        if tel is not None:
            # retirement invalidations land in the epoch's last window —
            # the window of event i, mirroring the engine's w_end rule
            tot = int(invalidated.sum())
            tel["invalidated"][i // telemetry] += tot - inv_seen
            inv_seen = tot
        press[:] = 0.0
        dropw = 0
        fracs_out.append(frac.copy())
        actives_out.append(active.copy())
    if len(trace) % e:   # trailing partial epoch: no re-split (see Autoscale)
        fracs_out.append(frac.copy())
        actives_out.append(active.copy())
    fracs = (np.stack(fracs_out) if fracs_out
             else np.zeros((0, n), np.float32))
    actives = (np.stack(actives_out) if actives_out
               else np.zeros((0, n), bool))
    extras = {"invalidated": invalidated, "node_up": up_mask,
              "active": actives}
    if tel is not None:
        extras["telemetry"] = tel
    if chains is not None:
        extras["chains"] = chain_np()
    if rz_on:
        extras["vertical"] = _vertical()
    return node_out, outcome_out, fracs, extras


# --------------------------------------------------------------------------
# historical single-knob API
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ContinuumConfig:
    n_nodes: int = 4
    node_mb: float = 4 * 1024.0
    policy: Policy = Policy.LRU
    kiss: bool = True                 # False => unified baseline nodes
    small_frac: float = 0.8
    cloud_rtt_s: float = 0.25         # edge->cloud round trip
    cloud_cold_prob: float = 0.05     # cloud has big warm pools

    def as_cluster(self, routing: RoutingPolicy = RoutingPolicy.STICKY,
                   max_slots: int = 1024) -> ClusterConfig:
        return ClusterConfig.homogeneous(
            self.n_nodes, self.node_mb, kiss=self.kiss,
            small_frac=self.small_frac, policy=self.policy, routing=routing,
            cloud_rtt_s=self.cloud_rtt_s,
            cloud_cold_prob=self.cloud_cold_prob, max_slots=max_slots)


@dataclasses.dataclass
class ContinuumResult:
    edge: ClassMetrics
    cloud_offloads: int
    latencies: np.ndarray             # per-invocation end-to-end seconds

    @property
    def offload_pct(self) -> float:
        n = len(self.latencies)
        return 100.0 * self.cloud_offloads / n if n else 0.0

    def latency_stats(self) -> dict:
        lat = self.latencies
        return {"mean_s": float(lat.mean()),
                "p50_s": float(np.percentile(lat, 50)),
                "p95_s": float(np.percentile(lat, 95)),
                "p99_s": float(np.percentile(lat, 99))}


@deprecated("repro_torch.sim.simulate(Scenario.cluster(...), engine='ref')")
def simulate_continuum(cfg: ContinuumConfig, trace: Trace,
                       rng_seed: int = 0) -> ContinuumResult:
    """Sticky-routed homogeneous continuum: a thin wrapper over the
    cluster oracle (pool capacities rounded through f32, ``max_slots``
    enforced), as the reference's."""
    node, outcome = cluster_outcomes_ref(cfg.as_cluster(), trace)
    cloud_cold = cloud_cold_draws(len(trace), cfg.cloud_cold_prob, rng_seed)
    latencies = continuum_latencies(trace, outcome, cloud_cold,
                                    cfg.cloud_rtt_s)
    warm = np.asarray(trace.warm_dur, np.float64)
    cold = np.asarray(trace.cold_dur, np.float64)
    metrics = ClassMetrics(
        hits=int((outcome == HIT).sum()),
        misses=int((outcome == MISS).sum()),
        drops=int((outcome == DROP).sum()),
        exec_time=float(warm[outcome == HIT].sum()
                        + cold[outcome == MISS].sum()))
    return ContinuumResult(edge=metrics,
                           cloud_offloads=int((outcome == DROP).sum()),
                           latencies=latencies)
