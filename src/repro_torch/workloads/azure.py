"""Azure-Functions-2019-like synthetic trace generation (paper §4.2).

A numpy copy of ``repro.workloads.azure`` for the port, which may not
import ``repro``; the same config and seed give the identical trace
(pinned by ``tests/test_torch_sim.py``).  Traces are synthesized to the
statistics the paper documents (small 30-60 MB and large 300-400 MB
containers, a 4-6.5x small:large invocation ratio, Fig 5's cold-start
shape, diurnal modulation and optional bursts), with times quantized to
1/64 s and sizes to whole MB so that float32 pool arithmetic is exact.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..core.types import Trace

_Q = 64.0  # time quantum: 1/64 s


def _quant(x: np.ndarray) -> np.ndarray:
    return np.round(np.asarray(x) * _Q) / _Q


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs for synthesizing an edge FaaS trace."""

    n_small_funcs: int = 220
    n_large_funcs: int = 8
    duration_s: float = 4 * 3600.0
    # aggregate invocations/sec across each class; tuned so the small:large
    # ratio lands in the paper's 4-6.5x band.  Calibrated (see
    # EXPERIMENTS.md, "Workload calibration") so that the baseline's
    # contention collapse and the KiSS recovery happen inside the 1-24 GB
    # edge band the paper sweeps.
    small_rps: float = 2.5
    large_rps: float = 0.5
    # container sizes (MB), edge-adapted per §4.2
    small_size_range: tuple[int, int] = (30, 60)
    large_size_range: tuple[int, int] = (300, 400)
    # warm execution durations (lognormal, seconds)
    small_warm_med: float = 0.5
    large_warm_med: float = 2.0
    warm_sigma: float = 0.8
    # cold-start *overhead* (lognormal): medians/sigmas fitted so the
    # percentile curves keep Fig 5's shape (small ~11 s p85; large ~60 s
    # p85 with a >100 s tail)
    small_cold_med: float = 4.0
    small_cold_sigma: float = 1.0
    large_cold_med: float = 15.0
    large_cold_sigma: float = 1.3
    # diurnal modulation depth [0,1) and burstiness
    diurnal_depth: float = 0.3
    burst_rate_mult: float = 1.0  # >1 adds bursts
    burst_fraction: float = 0.0   # fraction of time inside bursts
    zipf_a: float = 1.3           # popularity skew (lower = flatter)
    seed: int = 0


def _rates(rng: np.ndarray, n_funcs: int, total_rps: float,
           zipf_a: float = 1.3) -> np.ndarray:
    """Heavy-tailed per-function rate split (Zipf-ish, as in Azure data:
    a few functions dominate invocations)."""
    w = rng.zipf(zipf_a, size=n_funcs).astype(np.float64)
    w = np.minimum(w, 1e4)
    return total_rps * w / w.sum()


def _arrivals(rng, rate: float, duration: float, cfg: TraceConfig) -> np.ndarray:
    """Inhomogeneous Poisson arrivals with diurnal + burst modulation via
    thinning."""
    peak = rate * (1 + cfg.diurnal_depth) * max(cfg.burst_rate_mult, 1.0)
    n = rng.poisson(peak * duration)
    if n == 0:
        return np.zeros(0)
    t = np.sort(rng.uniform(0, duration, n))
    day = 24 * 3600.0
    lam = rate * (1 + cfg.diurnal_depth * np.sin(2 * np.pi * t / day))
    if cfg.burst_fraction > 0 and cfg.burst_rate_mult > 1:
        in_burst = (t / 600.0 % 1.0) < cfg.burst_fraction  # 10-min cycle
        lam = np.where(in_burst, lam * cfg.burst_rate_mult, lam)
    keep = rng.uniform(0, peak, len(t)) < lam
    return t[keep]


def synthesize(cfg: TraceConfig) -> Trace:
    rng = np.random.default_rng(cfg.seed)
    small_rates = _rates(rng, cfg.n_small_funcs, cfg.small_rps, cfg.zipf_a)
    large_rates = _rates(rng, cfg.n_large_funcs, cfg.large_rps, cfg.zipf_a)

    lo, hi = cfg.small_size_range
    small_sizes = rng.integers(lo, hi + 1, cfg.n_small_funcs)
    lo, hi = cfg.large_size_range
    large_sizes = rng.integers(lo, hi + 1, cfg.n_large_funcs)

    ts, fids, sizes, clss, warms, colds = [], [], [], [], [], []
    for i in range(cfg.n_small_funcs):
        t = _arrivals(rng, small_rates[i], cfg.duration_s, cfg)
        if len(t) == 0:
            continue
        ts.append(t)
        fids.append(np.full(len(t), i, np.int32))
        sizes.append(np.full(len(t), small_sizes[i], np.float32))
        clss.append(np.zeros(len(t), np.int32))
        warms.append(rng.lognormal(np.log(cfg.small_warm_med),
                                   cfg.warm_sigma, len(t)))
        colds.append(rng.lognormal(np.log(cfg.small_cold_med),
                                   cfg.small_cold_sigma, len(t)))
    for i in range(cfg.n_large_funcs):
        t = _arrivals(rng, large_rates[i], cfg.duration_s, cfg)
        if len(t) == 0:
            continue
        ts.append(t)
        fids.append(np.full(len(t), 10_000 + i, np.int32))
        sizes.append(np.full(len(t), large_sizes[i], np.float32))
        clss.append(np.ones(len(t), np.int32))
        warms.append(rng.lognormal(np.log(cfg.large_warm_med),
                                   cfg.warm_sigma, len(t)))
        colds.append(rng.lognormal(np.log(cfg.large_cold_med),
                                   cfg.large_cold_sigma, len(t)))

    t = np.concatenate(ts)
    order = np.argsort(t, kind="stable")
    warm = np.maximum(_quant(np.concatenate(warms)), 1 / _Q)
    cold_extra = np.maximum(_quant(np.concatenate(colds)), 1 / _Q)
    trace = Trace(
        t=_quant(t)[order].astype(np.float32),
        func_id=np.concatenate(fids)[order],
        size_mb=np.concatenate(sizes)[order],
        cls=np.concatenate(clss)[order],
        warm_dur=warm[order].astype(np.float32),
        cold_dur=(warm + cold_extra)[order].astype(np.float32),
    )
    return trace


# ---- named scenarios (paper §4.2 "Workload Diversity") --------------------

def edge_trace(seed: int = 0, duration_s: float = 4 * 3600.0,
               scale: float = 1.0) -> Trace:
    """Default mixed edge workload (calibrated — see TraceConfig)."""
    return synthesize(TraceConfig(seed=seed, duration_s=duration_s,
                                  small_rps=2.5 * scale,
                                  large_rps=0.5 * scale,
                                  zipf_a=1.15))


def bursty_trace(seed: int = 0, duration_s: float = 2 * 3600.0) -> Trace:
    """Traffic spikes: 3x rate inside 20% duty-cycle bursts."""
    return synthesize(TraceConfig(seed=seed, duration_s=duration_s,
                                  burst_rate_mult=3.0, burst_fraction=0.2))


def steady_trace(seed: int = 0, duration_s: float = 2 * 3600.0) -> Trace:
    """No diurnal modulation, no bursts — steady-state baseline."""
    return synthesize(TraceConfig(seed=seed, duration_s=duration_s,
                                  diurnal_depth=0.0))


def stress_trace(seed: int = 0, duration_s: float = 2 * 3600.0,
                 rps: float = 600.0) -> Trace:
    """§6.5 stress test: a 2-hour trace at millions-of-invocations scale.
    ``rps=600`` gives ~4.3M invocations over 2 h, matching the paper's
    '4-5 million invocations'.  Use a smaller ``rps`` for CI."""
    return synthesize(TraceConfig(
        seed=seed, duration_s=duration_s,
        n_small_funcs=400, n_large_funcs=100,
        small_rps=rps * 5 / 6, large_rps=rps / 6,
        burst_rate_mult=2.0, burst_fraction=0.15))


#: ``edge_trace(seed=0, duration_s=3600)`` (the README quickstart's
#: trace: 11,215 invocations, 140 functions) as the reference draws it
#: under numpy 2.0, stored as its six arrays.
QUICKSTART_TRACE_FILE = Path(__file__).with_name("edge_trace_seed0_3600s.npz")


def quickstart_trace() -> Trace:
    """The README quickstart's trace, loaded from
    :data:`QUICKSTART_TRACE_FILE`.

    ``edge_trace`` draws its popularity with ``Generator.zipf``, whose
    stream numpy 2.3 changed: there the same seed gives another trace
    (11,133 invocations).  The stored arrays are the same under every
    numpy, so a run anywhere can be held to the reference's results on
    this trace (pinned by ``tests/test_torch_sim.py``)."""
    with np.load(QUICKSTART_TRACE_FILE) as z:
        return Trace(t=z["t"], func_id=z["func_id"], size_mb=z["size_mb"],
                     cls=z["cls"], warm_dur=z["warm_dur"],
                     cold_dur=z["cold_dur"])
