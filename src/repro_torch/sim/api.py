"""The front door: ``simulate(scenario, trace)`` (port of
``repro.sim.api``).

``simulate`` runs on the CUDA device unless the caller passes
``device="cpu"``; with no card and no ``device`` it raises.  The step
mode is one of ``STEP_MODES`` (``"gather"``, ``"vmap"``, ``"fused"``),
all bitwise equal; ``"fused"`` runs the hand-written CUDA kernel of
``repro_torch.kernels.pool_step`` on a CUDA device and its plain torch
version on the CPU.  A scenario with ``failures``, ``autoscale``,
``telemetry``, ``chains`` or ``resize`` and a run with ``chunk_events``
give bitwise the reference's results.  Not ported yet: ``sweep`` (ROADMAP A12) and
the numpy oracle ``engine="ref"`` (A14).
"""
from __future__ import annotations

import numpy as np

from .._device import resolve_device
from ..cluster.engine import (_simulate_cluster, _simulate_cluster_autoscale,
                              check_chunk_events, check_step_mode)
from ..core.types import Trace
from .chains import metrics_from_arrays
from .result import Result
from .scenario import Scenario
from .telemetry import series_from_arrays, trace_fingerprint

_ENGINES = ("torch",)


def _telw(scenario: Scenario) -> int | None:
    """The scenario's telemetry window length (``None``: telemetry off),
    the engine-level form of the :class:`Telemetry` knob."""
    t = scenario.telemetry
    return t.window_events if t is not None else None


def _chain_plan(scenario: Scenario, trace: Trace):
    """Compile the scenario's :class:`Chains` knob against ``trace``
    into the engine-level ``ChainPlan`` (``None``: chains off)."""
    if scenario.chains is None:
        return None
    if not trace.has_chains:
        raise ValueError(
            "Scenario(..., chains=...) needs a chained trace "
            "(Trace.chain_id/stage/chain_len set) — e.g. "
            "repro_torch.workloads.chained_trace")
    return scenario.chains.compile(trace)


def simulate(scenario: Scenario, trace: Trace, *, engine: str = "torch",
             mode: str = "gather", rng_seed: int = 0,
             chunk_events: int | None = None, device=None) -> Result:
    """Run one scenario over ``trace`` and return the :class:`Result`.

    ``trace`` is a :class:`repro_torch.core.types.Trace` (a reference
    trace converts with ``Trace(*reference_trace)``).  ``rng_seed`` fixes
    the cloud cold-start draws (common random numbers, as the reference
    draws them).  ``chunk_events`` (a positive int, default ``None`` =
    monolithic) splits the trace into chunks that are uploaded and read
    back one at a time, with the pool state carried from chunk to chunk:
    bitwise the monolithic results, with device memory bounded by one
    chunk; it does not compose with an autoscaled scenario
    (``ValueError``, as in the reference).  A scenario with ``failures``
    also fills ``Result.node_up`` and ``Result.invalidated``; an
    autoscaled one fills the epoch trajectories ``Result.fracs``,
    ``active`` and ``epoch_t`` (and ``invalidated``: retirements); one
    with ``telemetry`` fills ``Result.telemetry`` (``timeline()``), and
    one with ``chains``, on a chained trace, ``Result.chains``
    (``chain_metrics()``), and one with ``resize`` ``Result.vertical``
    (``utilization_ratio``, ``bottleneck_events``).  ``device`` is where
    the run happens:
    ``None`` means ``"cuda"``."""
    if engine == "ref":
        raise NotImplementedError(
            "engine='ref' (the numpy oracle) is not in the PyTorch port "
            "yet (ROADMAP A14)")
    if engine not in _ENGINES:
        raise ValueError(f"engine must be one of {_ENGINES}, got {engine!r}")
    check_step_mode(mode)
    chunk = check_chunk_events(chunk_events)
    asc = scenario.autoscale
    if chunk is not None and asc is not None:
        raise ValueError(
            "chunk_events does not compose with autoscale: an autoscaled "
            "run already steps one epoch at a time; drop chunk_events or "
            "the Autoscale")
    telw = _telw(scenario)
    plan = _chain_plan(scenario, trace)
    dev = resolve_device(device)
    cfg = scenario.to_cluster_config()
    fracs = ep_t = None
    if asc is None:
        raw, extras = _simulate_cluster(cfg, trace, dev, rng_seed, mode,
                                        chunk, scenario.failures,
                                        telemetry=telw, chains=plan)
    else:
        raw, fracs, extras = _simulate_cluster_autoscale(
            cfg, asc, trace, dev, rng_seed, mode, scenario.failures,
            telemetry=telw, chains=plan)
        ep_t = _epoch_times(trace, asc.epoch_events)
    info = {"engine": engine, "mode": mode, "chunk_events": chunk,
            "devices": None, "device": str(dev), "rng_seed": rng_seed,
            "trace_fingerprint": trace_fingerprint(trace)}
    return Result(scenario=scenario, raw=raw, epoch_fracs=fracs,
                  epoch_active=extras.get("active"),
                  node_up=extras.get("node_up"),
                  invalidated=extras.get("invalidated"),
                  telemetry=(None if telw is None else series_from_arrays(
                      extras["telemetry"], trace, telw)),
                  chains=(None if plan is None else metrics_from_arrays(
                      extras["chains"], plan)),
                  run_info=info, epoch_t=ep_t,
                  vertical=extras.get("vertical"))


def _epoch_times(trace: Trace, epoch_events: int) -> np.ndarray | None:
    """f32[E] time of each epoch's last event (``None`` for an empty
    trace), as the reference's ``_wrap`` computes it."""
    if not len(trace):
        return None
    n_ep = -(-len(trace) // epoch_events)
    t = np.asarray(trace.t, np.float32)
    return t[np.minimum((np.arange(n_ep) + 1) * epoch_events - 1,
                        len(trace) - 1)]
