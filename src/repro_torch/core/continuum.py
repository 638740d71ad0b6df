"""Edge-cloud continuum: the cluster config and its host-side numpy data.

The parts of ``repro.core.continuum`` the static cluster path needs,
copied byte for byte because they are shared verbatim with the
reference: ``ClusterConfig`` (with ``pool_caps``), the routing hashes,
the pre-drawn cloud cold-start coins, the end-to-end pricing, the
failure schedule (``Failures``, compiled on the host into per-event
masks), the autoscaler's knob (``Autoscale``) and the chain plan
(``ChainPlan``, ``compile_chains``).  The numpy oracle
(``cluster_outcomes_ref``) is not ported yet (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as np

from .registry import REPLACEMENT, RESIZE, ROUTING
from .types import HIT, MISS, ClassMetrics, Policy, Trace


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
