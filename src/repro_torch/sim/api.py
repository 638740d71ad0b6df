"""The front door: ``simulate(scenario, trace)`` and ``sweep`` (port of
``repro.sim.api``), with two engines:

* ``engine="torch"`` (the default) runs on the CUDA device unless the
  caller passes ``device="cpu"``; with no card and no ``device`` it
  raises.  The step mode is one of ``STEP_MODES`` (``"gather"``,
  ``"vmap"``, ``"fused"``), all bitwise equal; ``"fused"`` runs the
  hand-written CUDA kernel of ``repro_torch.kernels.pool_step`` on a
  CUDA device and its plain torch version on the CPU.
* ``engine="ref"`` is the sequential numpy oracle
  (``repro_torch.core.continuum.cluster_outcomes_ref``), one event at a
  time on the host: the ground truth the torch engine is held to.  It
  needs no card; ``mode``, ``chunk_events``, ``devices`` and ``device``
  are validated and then ignored, as the reference ignores them.

A scenario with ``failures``, ``autoscale``, ``telemetry``, ``chains``
or ``resize``, a run with ``chunk_events`` and a sweep sharded across
devices (``devices``) give bitwise the reference's results on either
engine, one run or a sweep's lane.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from .. import obs
from .._device import resolve_device
from ..cluster.engine import (_run_group, _run_group_autoscale,
                              _simulate_cluster_autoscale_ref,
                              _simulate_cluster_failures_ref,
                              _simulate_cluster_ref, check_chunk_events,
                              check_devices, check_step_mode)
from ..core.types import Trace
from .chains import metrics_from_arrays
from .result import Result
from .scenario import Scenario
from .telemetry import series_from_arrays, trace_fingerprint

_ENGINES = ("torch", "ref")


def _check_engine(engine: str) -> None:
    if engine not in _ENGINES:
        raise ValueError(f"engine must be one of {_ENGINES}, got {engine!r}")


def _check_host_device(device) -> None:
    """The oracle runs on the host: ``device`` is validated as a device
    spelling and never resolved, so no card is needed."""
    if device is not None and torch.device(device).type not in ("cuda",
                                                                "cpu"):
        raise ValueError(f"device must be a CUDA or CPU device, got "
                         f"{device!r}")


def _check_chunkable(scenario: Scenario, chunk_events) -> int | None:
    """Shared ``chunk_events`` validation for simulate and sweep."""
    chunk = check_chunk_events(chunk_events)
    if chunk is not None and scenario.autoscale is not None:
        raise ValueError(
            "chunk_events does not compose with autoscale: an autoscaled "
            "run already steps one epoch at a time; drop chunk_events or "
            "the Autoscale")
    return chunk


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


def _wrap(scenario: Scenario, trace: Trace, raw, extras: dict, fracs,
          telw: int | None, info: dict, plan=None) -> Result:
    """Assemble the :class:`Result`: lift the window arrays into a
    :class:`TelemetrySeries` and the per-chain arrays into a
    :class:`ChainMetrics`, attach the run info and, for an autoscaled
    run, the epoch-boundary time axis."""
    ep_t = None
    if scenario.autoscale is not None:
        ep_t = _epoch_times(trace, scenario.autoscale.epoch_events)
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
    the run happens: ``None`` means ``"cuda"``.  ``engine="ref"`` runs
    the numpy oracle on the host instead, with bitwise the same
    :class:`Result` (``run_info`` aside); it validates ``mode``,
    ``chunk_events`` and ``device`` and ignores them."""
    _check_engine(engine)
    check_step_mode(mode)
    chunk = _check_chunkable(scenario, chunk_events)
    if engine == "ref":
        _check_host_device(device)
        return _simulate_ref(scenario, trace, rng_seed)
    return sweep(trace, [scenario], engine=engine, mode=mode,
                 rng_seed=rng_seed, chunk_events=chunk, device=device)[0]


def _simulate_ref(scenario: Scenario, trace: Trace, rng_seed: int) -> Result:
    """One scenario through the numpy oracle, dispatched as the
    reference's ``simulate`` dispatches ``engine="ref"``; ``run_info``
    records no mode, chunking or device count, and the host as the
    device."""
    cfg = scenario.to_cluster_config()
    asc, fails = scenario.autoscale, scenario.failures
    telw = _telw(scenario)
    plan = _chain_plan(scenario, trace)
    info = {"engine": "ref", "mode": None, "chunk_events": None,
            "devices": None, "device": "cpu", "rng_seed": rng_seed,
            "trace_fingerprint": trace_fingerprint(trace)}
    fracs = None
    if asc is not None:
        raw, fracs, extras = _simulate_cluster_autoscale_ref(
            cfg, asc, trace, rng_seed, failures=fails, telemetry=telw,
            chains=plan)
    elif fails is not None:
        raw, extras = _simulate_cluster_failures_ref(
            cfg, fails, trace, rng_seed, telemetry=telw, chains=plan)
    else:
        out = _simulate_cluster_ref(cfg, trace, rng_seed, telemetry=telw,
                                    chains=plan)
        bare = telw is None and plan is None and scenario.resize is None
        raw, extras = (out, {}) if bare else out
    return _wrap(scenario, trace, raw, extras, fracs, telw, info, plan)


def sweep(trace: Trace, scenarios: Iterable[Scenario], *,
          engine: str = "torch", mode: str | Sequence[str] = "gather",
          rng_seed: int = 0, chunk_events: int | None = None,
          devices: int | str | None = None, device=None) -> list[Result]:
    """Evaluate many scenarios on one trace; results in input order.

    Scenarios that share the stacked shapes and the run's shape (the
    reference's bucket key: ``n_nodes``, ``max_slots``, the epoch length
    of an autoscaled scenario, failures on or off, the telemetry window,
    chains on or off, vertical scaling on or off, and the step mode) run
    as ONE group: its lanes are a leading tensor axis of one cluster step
    and, on the card, of one block runner, so each block of events is
    one CUDA graph replay for every lane (one B1 launch an event for all
    of the group's pools in ``"fused"``).  Everything else a scenario
    sets is per-lane data: capacities and splits, routing and
    replacement policies, cloud pricing, failure windows, deadlines,
    resize policies and floors, the autoscaler's parameters.  Each lane
    is bitwise the same scenario's :func:`simulate` and the reference's
    sweep lane.

    ``mode`` is one step formulation for every lane or a per-scenario
    sequence (lanes bucket by it).  ``chunk_events`` runs every group
    chunk by chunk (see :func:`simulate`), carrying all of its lanes'
    state at once; an autoscaled scenario refuses it (``ValueError``).
    ``devices`` shards each group's lanes as the reference's mesh does:
    ``None`` runs every group on ``device``; ``k`` (or ``"all"``: every
    device of the run's type) cuts each group's lanes, padded with
    copies of its first lane to a multiple of ``k``, into ``k`` shards,
    shard ``j`` on ``cuda:j`` (a CPU run has one device, so ``k`` is at
    most 1 there), shards on distinct cards at once; a count above the
    devices available raises ``ValueError`` before any work.  Each lane
    is bitwise its unsharded self.  ``engine="ref"`` runs
    :func:`simulate` with the numpy oracle for each scenario in input
    order, after the same validation (``mode``, ``chunk_events``,
    ``devices`` and ``device`` are then ignored, as the reference
    ignores them).  ``device`` is where the run happens:
    ``None`` means ``"cuda"``, and without a card it raises (pass
    ``device="cpu"``).  Under ``torch.profiler.profile`` the torch
    engine records its phases as spans (:mod:`repro_torch.obs`)."""
    _check_engine(engine)
    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("sweep: scenarios must be non-empty")
    if isinstance(mode, str):
        modes = [mode] * len(scenarios)
    else:
        modes = list(mode)
        if len(modes) != len(scenarios):
            raise ValueError(
                f"sweep: per-scenario mode needs {len(scenarios)} "
                f"entries, got {len(modes)}")
    for m in modes:
        check_step_mode(m)
    chunk = None
    for s in scenarios:
        chunk = _check_chunkable(s, chunk_events)
    dev_count = check_devices(devices,
                              None if engine == "ref" else device)
    if engine == "ref":
        _check_host_device(device)
        return [simulate(s, trace, engine="ref", rng_seed=rng_seed)
                for s in scenarios]
    with obs.span("sweep"):
        with obs.span("sweep.plan"):
            plans = [_chain_plan(s, trace) for s in scenarios]
            dev = resolve_device(device)
            groups: dict[tuple, list[int]] = {}
            for i, s in enumerate(scenarios):
                epoch = s.autoscale.epoch_events if s.autoscale else None
                groups.setdefault(
                    (s.n_nodes, s.max_slots, epoch, s.failures is not None,
                     _telw(s), plans[i] is not None, s.resize is not None,
                     modes[i]), []).append(i)
            results: list[Result | None] = [None] * len(scenarios)
            base_info = {"engine": engine, "chunk_events": chunk,
                         "devices": dev_count, "device": str(dev),
                         "rng_seed": rng_seed,
                         "trace_fingerprint": trace_fingerprint(trace)}
        for ((_, _, epoch, failing, telw, chained, _, gmode),
             idxs) in groups.items():
            with obs.span("sweep.plan"):
                scns = [scenarios[i] for i in idxs]
                cfgs = [s.to_cluster_config() for s in scns]
                fails = [s.failures for s in scns] if failing else None
                chs = [plans[i] for i in idxs] if chained else None
                info = {**base_info, "mode": gmode}
            if epoch is None:
                outs = [(raw, None, extras) for raw, extras in _run_group(
                    cfgs, trace, dev, rng_seed, gmode, chunk, fails, telw, chs,
                    "sweep", devices=dev_count)]
            else:
                outs = _run_group_autoscale(
                    cfgs, [s.autoscale for s in scns], trace, dev, rng_seed,
                    gmode, fails, telw, chs, "sweep", devices=dev_count)
            with obs.span("sweep.wrap"):
                for i, (raw, fracs, extras) in zip(idxs, outs):
                    results[i] = _wrap(scenarios[i], trace, raw, extras, fracs,
                                       telw, info, plans[i])
        return results


def _epoch_times(trace: Trace, epoch_events: int) -> np.ndarray | None:
    """f32[E] time of each epoch's last event (``None`` for an empty
    trace), as the reference's ``_wrap`` computes it."""
    if not len(trace):
        return None
    n_ep = -(-len(trace) // epoch_events)
    t = np.asarray(trace.t, np.float32)
    return t[np.minimum((np.arange(n_ep) + 1) * epoch_events - 1,
                        len(trace) - 1)]
