"""Function chains with end-to-end deadlines (port of
``repro.sim.chains``).

Serverless workflows invoke functions in chains (A -> B -> C ...), and
what users feel is the chain-complete latency against an end-to-end
SLO.  ``Scenario(..., chains=Chains(...))`` makes a run account every
chain: its accumulated end-to-end latency (f32, stage by stage in event
order), whether any stage dropped, and, judged at the chain's final
stage, whether the deadline was missed (late, or any stage dropped).
Chains whose final stage falls outside the trace are never judged
(``done`` False).  Each event's remaining slack (``deadline -
elapsed``) and stage reach routing through ``RouteCtx.chain_slack`` /
``chain_stage``, so ``slack_aware`` can shed doomed chains.  The
per-chain arrays equal the reference's bitwise
(``tests/test_torch_chains.py``), chunked or not.

The engine-level plan (:class:`repro_torch.core.continuum.ChainPlan`)
lives in ``repro_torch.core``; this module is the user-facing knob and
result view.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.continuum import ChainPlan, compile_chains
from ..core.types import Trace


@dataclasses.dataclass(frozen=True)
class Chains:
    """The chain knob on :class:`repro_torch.sim.Scenario`.

    Exactly one of:

    * ``deadline_s`` — one absolute end-to-end deadline (seconds) for
      every chain;
    * ``slack`` — per-chain deadline = ``slack x`` the chain's summed
      warm durations (its all-warm critical path): ``slack=1.0`` means
      "no room for a single cold start", ``slack=3.0`` is a loose SLO;
    * neither — chains are tracked (latency, drops) with ``+inf``
      deadlines: only a dropped stage can miss.

    Frozen and hashable like every other scenario knob.
    """

    deadline_s: float | None = None
    slack: float | None = None

    def __post_init__(self):
        if self.deadline_s is not None and self.slack is not None:
            raise ValueError("Chains: pass deadline_s or slack, not both")
        for name in ("deadline_s", "slack"):
            v = getattr(self, name)
            if v is None:
                continue
            try:
                v = float(v)
            except (TypeError, ValueError):
                raise ValueError(
                    f"Chains.{name} must be a positive number, got "
                    f"{getattr(self, name)!r}") from None
            if not v > 0.0:
                raise ValueError(
                    f"Chains.{name} must be positive, got {v}")
            object.__setattr__(self, name, v)

    def compile(self, trace: Trace) -> ChainPlan:
        """The engine-level :class:`ChainPlan` for ``trace`` (requires
        ``trace.has_chains``)."""
        return compile_chains(trace, deadline_s=self.deadline_s,
                              slack=self.slack)


@dataclasses.dataclass(frozen=True)
class ChainMetrics:
    """Per-chain accounting one chain-tracked run produces (``C`` =
    number of chain instances in the trace).

    ``latency`` is f32 and bit-equal to the reference's; ``done`` is False
    for chains whose final stage fell outside the simulated trace —
    those are excluded from every rate below (they were never judged).
    """

    #: f32[C] accumulated end-to-end latency over the observed stages
    latency: np.ndarray
    #: bool[C] any observed stage dropped to the cloud
    dropped: np.ndarray
    #: bool[C] the chain's final stage was simulated (deadline judged)
    done: np.ndarray
    #: bool[C] deadline missed (late at the final stage, or any drop)
    missed: np.ndarray
    #: f32[C] the per-chain deadline the run enforced (+inf = none)
    deadline: np.ndarray

    def __len__(self) -> int:
        return int(self.latency.shape[0])

    @property
    def n_chains(self) -> int:
        return len(self)

    @property
    def n_done(self) -> int:
        """Chains whose final stage was simulated."""
        return int(self.done.sum())

    @property
    def chain_latency(self) -> np.ndarray:
        """f32[done] end-to-end latencies of the completed chains."""
        return self.latency[self.done]

    @property
    def chain_latency_mean_s(self) -> float:
        lat = self.chain_latency
        return float(lat.mean()) if len(lat) else 0.0

    @property
    def chain_p95_s(self) -> float:
        lat = self.chain_latency
        return float(np.percentile(lat, 95)) if len(lat) else 0.0

    @property
    def deadline_miss_pct(self) -> float:
        """Percent of *completed* chains that missed their deadline —
        the headline SLO metric."""
        n = self.n_done
        return 100.0 * float(self.missed.sum()) / n if n else 0.0

    def table(self) -> list[dict]:
        """One plain-dict row per chain — the quick-look view."""
        return [{"chain": c,
                 "latency_s": float(self.latency[c]),
                 "deadline_s": float(self.deadline[c]),
                 "done": bool(self.done[c]),
                 "dropped": bool(self.dropped[c]),
                 "missed": bool(self.missed[c])}
                for c in range(len(self))]


def metrics_from_arrays(arrays: dict, plan: ChainPlan) -> ChainMetrics:
    """Assemble :class:`ChainMetrics` from the engine-level per-chain
    arrays (already junk-row-free) plus the plan's deadlines."""
    return ChainMetrics(
        latency=np.asarray(arrays["latency"], np.float32),
        dropped=np.asarray(arrays["dropped"], bool),
        done=np.asarray(arrays["done"], bool),
        missed=np.asarray(arrays["missed"], bool),
        deadline=np.asarray(plan.deadline[:plan.n_chains], np.float32))
