"""``Scenario`` — one frozen spec for a simulation (port of
``repro.sim.scenario``).

The same fields and constructors as the reference, so one scenario reads
the same in both packages::

    Scenario.kiss(4 * 1024.0)                  # one KiSS 80-20 edge node
    Scenario.baseline(4 * 1024.0)              # one unified-pool node
    Scenario.cluster((1024.0,) * 8 + (6144.0,) * 4,
                     routing="size_aware")     # heterogeneous cluster

The port runs static, failure-injected (``failures=`` a
:class:`~repro_torch.core.continuum.Failures` or an iterable of
``(t_down, t_up, node)`` windows) and autoscaled scenarios
(``autoscale=`` an :class:`~repro_torch.core.continuum.Autoscale` or a
dict of its arguments), each with telemetry (``telemetry=`` a
:class:`~repro_torch.sim.telemetry.Telemetry`, a window length in events
or a dict), function chains (``chains=`` a
:class:`~repro_torch.sim.chains.Chains` or a dict) and vertical scaling
(``resize=`` a :class:`Resize`, a registered resize-policy name or a
dict).
"""
from __future__ import annotations

import collections.abc
import dataclasses
from typing import Sequence

import numpy as np

from ..core.continuum import Autoscale, ClusterConfig, Failures
from ..core.registry import REPLACEMENT, RESIZE, ROUTING
from .chains import Chains
from .telemetry import Telemetry


@dataclasses.dataclass(frozen=True)
class Resize:
    """Vertical scaling: per-container dynamic memory limits.

    With a resize policy set, every resident carries its observed memory
    usage beside its limit, and a miss under memory pressure first
    shrinks idle residents toward that usage, as the registered policy
    proposes and never below ``max(min_mb, used)``, and evicts only what
    shrinking cannot cover.  A hit on a container whose limit was shrunk
    below its footprint is a *bottleneck event*;
    ``Result.utilization_ratio`` and ``Result.bottleneck_events`` show
    the trade-off.  ``policy`` is a name registered with
    ``register_resize_policy`` (built-ins: ``"static"``, which proposes
    no change, and ``"fair_share"``, LaSS-style proportional reclamation
    of idle headroom); ``min_mb`` is the floor of every limit."""

    policy: str = "fair_share"
    min_mb: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "policy", RESIZE.spec(self.policy).name)
        object.__setattr__(self, "min_mb", float(self.min_mb))
        if self.min_mb < 0.0:
            raise ValueError(f"min_mb must be >= 0, got {self.min_mb}")


def _is_seq(x) -> bool:
    """Any per-node sequence (a 0-d array is a scalar and broadcasts)."""
    return ((isinstance(x, np.ndarray) and x.ndim > 0) or
            (isinstance(x, collections.abc.Sequence)
             and not isinstance(x, (str, bytes))))


def _tuple_of(x, n: int, cast, what: str) -> tuple:
    """Broadcast a scalar (or pass a length-``n`` sequence) to a tuple."""
    if _is_seq(x):
        if len(x) != n:
            raise ValueError(f"{what} must have {n} entries, got {len(x)}")
        return tuple(cast(v) for v in x)
    return (cast(x),) * n


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A complete, frozen simulation configuration.

    ``node_mb``/``small_frac``/``unified`` are per-node tuples (scalars
    broadcast); ``replacement`` and ``routing`` are registered policy
    names (codes and enum members are normalized to names).  The step
    mode is an execution knob of :func:`repro_torch.sim.simulate`, not
    part of the scenario."""

    node_mb: tuple[float, ...]
    small_frac: tuple[float, ...] = 0.8
    unified: tuple[bool, ...] = False
    replacement: str = "lru"
    routing: str = "sticky"
    cloud_rtt_s: float = 0.25
    cloud_cold_prob: float = 0.05
    max_slots: int = 1024
    autoscale: object = None
    failures: object = None
    telemetry: object = None
    chains: object = None
    resize: object = None
    name: str = ""

    def __post_init__(self):
        nm = self.node_mb
        if not _is_seq(nm):
            nm = (nm,)
        n = len(nm)
        if n == 0:
            raise ValueError("Scenario needs at least one node")
        object.__setattr__(self, "node_mb", tuple(float(v) for v in nm))
        object.__setattr__(self, "small_frac",
                           _tuple_of(self.small_frac, n, float, "small_frac"))
        object.__setattr__(self, "unified",
                           _tuple_of(self.unified, n, bool, "unified"))
        if any(v <= 0 for v in self.node_mb):
            raise ValueError("node_mb entries must be positive")
        if any(not 0.0 < f < 1.0
               for f, u in zip(self.small_frac, self.unified) if not u):
            raise ValueError("small_frac must be in (0, 1) for KiSS nodes")
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if not 0.0 <= self.cloud_cold_prob <= 1.0:
            raise ValueError("cloud_cold_prob must be in [0, 1]")
        if self.failures is not None:
            f = self.failures
            if not isinstance(f, Failures):
                try:
                    f = Failures(windows=tuple(f))
                except TypeError:
                    raise ValueError(
                        "failures must be a Failures, an iterable of "
                        f"(t_down, t_up, node) windows, or None, got "
                        f"{f!r}") from None
            if f.max_node >= n:
                raise ValueError(
                    f"failures references node {f.max_node} but the "
                    f"scenario has {n} nodes")
            object.__setattr__(self, "failures", f)
        if self.autoscale is not None:
            asc = self.autoscale
            if isinstance(asc, dict):
                asc = Autoscale(**asc)
            if not isinstance(asc, Autoscale):
                raise ValueError("autoscale must be an Autoscale, a kwargs "
                                 f"dict, or None, got {asc!r}")
            # an all-unified cluster has no split to re-tune, but node
            # add/remove is still meaningful there
            if all(self.unified) and not asc.node_scaled:
                raise ValueError(
                    "autoscale needs at least one KiSS node to re-split")
            if asc.init_active is not None and asc.init_active > n:
                raise ValueError(
                    f"init_active={asc.init_active} exceeds the "
                    f"scenario's {n} nodes")
            # a start outside the bounds would be silently clamped (and
            # pools resized) at the first epoch: surface it here instead
            if any(not asc.min_frac <= f <= asc.max_frac
                   for f, u in zip(self.small_frac, self.unified) if not u):
                raise ValueError(
                    "small_frac of every KiSS node must start inside "
                    f"[min_frac, max_frac] = [{asc.min_frac}, "
                    f"{asc.max_frac}]")
            object.__setattr__(self, "autoscale", asc)
        if self.telemetry is not None:
            t = self.telemetry
            if isinstance(t, int) and not isinstance(t, bool):
                t = Telemetry(window_events=t)
            elif isinstance(t, dict):
                t = Telemetry(**t)
            if not isinstance(t, Telemetry):
                raise ValueError(
                    "telemetry must be a Telemetry, a window length in "
                    f"events, a kwargs dict, or None, got {t!r}")
            object.__setattr__(self, "telemetry", t)
        if self.chains is not None:
            c = self.chains
            if isinstance(c, dict):
                c = Chains(**c)
            if not isinstance(c, Chains):
                raise ValueError(
                    "chains must be a Chains, a kwargs dict, or None, "
                    f"got {c!r}")
            object.__setattr__(self, "chains", c)
        if self.resize is not None:
            r = self.resize
            if isinstance(r, str):
                r = Resize(policy=r)
            elif isinstance(r, dict):
                r = Resize(**r)
            if not isinstance(r, Resize):
                raise ValueError(
                    "resize must be a Resize, a registered resize-policy "
                    f"name, a kwargs dict, or None, got {r!r}")
            object.__setattr__(self, "resize", r)
        # canonicalize policies to registered names (raises on unknown)
        object.__setattr__(
            self, "replacement",
            REPLACEMENT.spec(self.replacement).name)
        object.__setattr__(self, "routing", ROUTING.spec(self.routing).name)

    # -- constructors ------------------------------------------------------
    @classmethod
    def kiss(cls, total_mb: float, *, small_frac: float = 0.8,
             replacement="lru", max_slots: int = 1024, **kw) -> "Scenario":
        """The paper's policy on one edge node: two pools split
        ``small_frac`` / ``1 - small_frac``."""
        return cls(node_mb=(float(total_mb),), small_frac=small_frac,
                   unified=False, replacement=replacement,
                   max_slots=max_slots, **kw)

    @classmethod
    def baseline(cls, total_mb: float, *, replacement="lru",
                 max_slots: int = 1024, **kw) -> "Scenario":
        """The paper's baseline: one unified warm pool."""
        return cls(node_mb=(float(total_mb),), unified=True,
                   replacement=replacement, max_slots=max_slots, **kw)

    @classmethod
    def cluster(cls, node_mb: Sequence[float], *, small_frac=0.8,
                unified=False, routing="sticky", replacement="lru",
                max_slots: int = 1024, **kw) -> "Scenario":
        """A (possibly heterogeneous) edge cluster in front of the cloud
        tier; scalars broadcast across nodes."""
        return cls(node_mb=tuple(node_mb), small_frac=small_frac,
                   unified=unified, routing=routing,
                   replacement=replacement, max_slots=max_slots, **kw)

    @classmethod
    def from_cluster(cls, cfg: ClusterConfig, name: str = "") -> "Scenario":
        """Lift a :class:`ClusterConfig` into a scenario."""
        return cls(node_mb=cfg.node_mb, small_frac=cfg.small_frac,
                   unified=cfg.unified,
                   replacement=REPLACEMENT.spec(cfg.policy).name,
                   routing=ROUTING.spec(cfg.routing).name,
                   cloud_rtt_s=cfg.cloud_rtt_s,
                   cloud_cold_prob=cfg.cloud_cold_prob,
                   max_slots=cfg.max_slots, name=name)

    # -- views -------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.node_mb)

    @property
    def label(self) -> str:
        """Human-readable identity: explicit ``name`` or a derived one."""
        if self.name:
            return self.name
        kind = ("baseline" if all(self.unified)
                else "kiss" if self.n_nodes == 1 else "cluster")
        asc = "-autoscaled" if self.autoscale is not None else ""
        fail = "-failures" if self.failures is not None else ""
        ch = "-chains" if self.chains is not None else ""
        rz = "-resize" if self.resize is not None else ""
        return (f"{kind}-{self.n_nodes}n-{self.routing}"
                f"-{self.replacement}{asc}{fail}{ch}{rz}")

    def to_cluster_config(self) -> ClusterConfig:
        """The engine-level config."""
        return ClusterConfig(
            node_mb=self.node_mb, small_frac=self.small_frac,
            unified=self.unified,
            policy=REPLACEMENT.resolve(self.replacement),
            routing=ROUTING.resolve(self.routing),
            cloud_rtt_s=self.cloud_rtt_s,
            cloud_cold_prob=self.cloud_cold_prob,
            max_slots=self.max_slots,
            resize_policy=(None if self.resize is None
                           else RESIZE.resolve(self.resize.policy)),
            resize_min_mb=(0.0 if self.resize is None
                           else self.resize.min_mb))
