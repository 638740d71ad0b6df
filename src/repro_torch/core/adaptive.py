"""Adaptive partitioning (the paper's §7.3 future work) as a scenario
mode; a copy of ``repro.core.adaptive``.

Adaptive partitioning re-tunes the KiSS split every epoch from the
observed per-class pressure, and is a first-class scenario mode::

    from repro_torch.sim import Autoscale, Scenario, simulate

    res = simulate(Scenario.kiss(total_mb,
                                 autoscale=Autoscale(epoch_events=512)),
                   trace)
    res.fracs          # f32[epochs, nodes] split trajectory

:func:`simulate_kiss_adaptive` is the reference's deprecation shim over a
1-node autoscaled scenario (the epoch loop lives in
``repro_torch.cluster.engine``, its numpy oracle in ``core/continuum.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .compat import deprecated
from .continuum import Autoscale
from .types import KissConfig, SimResult, Trace


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    base: KissConfig
    epoch_events: int = 512
    min_frac: float = 0.5
    max_frac: float = 0.9
    gain: float = 0.15  # fraction step per epoch toward the pressured class

    def as_autoscale(self) -> Autoscale:
        return Autoscale(epoch_events=self.epoch_events,
                         min_frac=self.min_frac, max_frac=self.max_frac,
                         gain=self.gain)


@deprecated("repro_torch.sim.simulate(Scenario.kiss(..., autoscale=...))")
def simulate_kiss_adaptive(cfg: AdaptiveConfig, trace: Trace,
                           device=None) -> tuple[SimResult, np.ndarray]:
    """Run KiSS with per-epoch adaptive re-splitting on ``device``
    (``None`` is the CUDA device).

    Returns ``(SimResult, fractions_per_epoch)`` like the reference,
    forwarding to the port's autoscaled-scenario engine.
    """
    # deferred: repro_torch.sim imports this package, not the other way
    from ..sim import Scenario, simulate
    base = cfg.base
    if base.small_policy is not None or base.large_policy is not None:
        raise ValueError("per-pool policy overrides are not supported by "
                         "the autoscaled scenario path")
    if not cfg.min_frac <= base.small_frac <= cfg.max_frac:
        raise ValueError(
            f"AdaptiveConfig.base.small_frac={base.small_frac} must start "
            f"inside [min_frac, max_frac] = [{cfg.min_frac}, "
            f"{cfg.max_frac}]")
    scenario = Scenario.kiss(base.total_mb, small_frac=base.small_frac,
                             replacement=base.policy,
                             max_slots=base.max_slots,
                             autoscale=cfg.as_autoscale())
    res = simulate(scenario, trace, device=device)
    return res.per_class(), np.asarray(res.fracs[:, 0], np.float64)
