"""Workload analyzer (paper §2.5 + the 'workload analyzer' box of Fig 6);
a numpy copy of ``repro.core.analyzer``.

Consumes an invocation trace and produces the statistics the KiSS policy is
parameterised by: function-memory estimates (Eq. 1), the small/large size
threshold, invocation-frequency profiles per class, sliding-window
inter-arrival times (§2.5.3) and percentile distributions (Figs 2-5).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .types import LARGE, SMALL, Trace


def estimate_function_memory(app_memory_mb: np.ndarray,
                             func_duration: np.ndarray,
                             app_duration: np.ndarray) -> np.ndarray:
    """Paper Eq. (1): FunctionMemory = AppMemory * FuncDuration / AppDuration."""
    return app_memory_mb * func_duration / np.maximum(app_duration, 1e-9)


def classify(size_mb: np.ndarray, threshold_mb: float = 225.0) -> np.ndarray:
    """Static size classifier: 0 = small, 1 = large (paper §2.5.1: the
    footprint distribution spikes around 225 MB)."""
    return (size_mb >= threshold_mb).astype(np.int32)


def percentile_distribution(values: np.ndarray,
                            percentiles=None) -> tuple[np.ndarray, np.ndarray]:
    """Percentile curve as plotted in Figs 2, 4, 5."""
    if percentiles is None:
        percentiles = np.arange(1, 100)
    return np.asarray(percentiles), np.percentile(values, percentiles)


def invocation_ratio(trace: Trace, bucket_s: float = 60.0) -> dict:
    """Fig 3: per-minute invocation counts for small vs large functions and
    their ratio (the paper observes 4-6.5x)."""
    t = np.asarray(trace.t)
    cls = np.asarray(trace.cls)
    if len(t) == 0:
        return {"small": np.zeros(0), "large": np.zeros(0), "ratio": np.nan}
    edges = np.arange(t.min(), t.max() + bucket_s, bucket_s)
    small, _ = np.histogram(t[cls == SMALL], bins=edges)
    large, _ = np.histogram(t[cls == LARGE], bins=edges)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(large > 0, small / np.maximum(large, 1), np.nan)
    return {"small": small, "large": large,
            "ratio": float(np.nanmean(ratio))}


def sliding_window_iats(trace: Trace, window_s: float = 3600.0,
                        stride_s: float = 1800.0,
                        z_thresh: float = 3.0) -> dict:
    """§2.5.3: per-function IATs computed inside overlapping windows
    (default 60-min windows, 30-min stride) with Z-score outlier filtering.
    Returns mean IAT arrays per class."""
    t = np.asarray(trace.t)
    fid = np.asarray(trace.func_id)
    cls = np.asarray(trace.cls)
    out = {SMALL: [], LARGE: []}
    if len(t) == 0:
        return {"small": np.zeros(0), "large": np.zeros(0)}
    t0, t1 = float(t.min()), float(t.max())
    start = t0
    while start <= t1:
        in_win = (t >= start) & (t < start + window_s)
        for c in (SMALL, LARGE):
            sel = in_win & (cls == c)
            ts, fs = t[sel], fid[sel]
            iats = []
            for f in np.unique(fs):
                ft = np.sort(ts[fs == f])
                if len(ft) >= 2:
                    iats.append(np.diff(ft))
            if iats:
                arr = np.concatenate(iats)
                if len(arr) > 2 and arr.std() > 0:
                    z = np.abs((arr - arr.mean()) / arr.std())
                    arr = arr[z < z_thresh]
                if len(arr):
                    out[c].append(arr.mean())
        start += stride_s
    return {"small": np.asarray(out[SMALL]), "large": np.asarray(out[LARGE])}


@dataclasses.dataclass
class WorkloadProfile:
    """Summary the KiSS load balancer is driven by (Fig 6)."""

    threshold_mb: float
    small_count: int
    large_count: int
    invocation_ratio: float
    small_mem_p99: float
    large_mem_p99: float
    small_cold_p85: float
    large_cold_p85: float

    @property
    def suggested_small_frac(self) -> float:
        """Heuristic split suggestion: the paper prioritises the small pool
        because small functions dominate invocations (4-6.5x); the
        invocation share of the small class (~0.8 on Azure-like traffic)
        reproduces the paper's empirically-chosen 80-20 split."""
        total = self.small_count + self.large_count
        frac = self.small_count / max(total, 1)
        return float(np.clip(frac, 0.5, 0.9))


def analyze(trace: Trace, threshold_mb: float = 225.0) -> WorkloadProfile:
    size = np.asarray(trace.size_mb)
    cls = np.asarray(trace.cls)
    cold_lat = np.asarray(trace.cold_dur) - np.asarray(trace.warm_dur)
    small_m, large_m = size[cls == SMALL], size[cls == LARGE]
    small_c, large_c = cold_lat[cls == SMALL], cold_lat[cls == LARGE]
    ratio = invocation_ratio(trace)["ratio"]
    pct = lambda a, q: float(np.percentile(a, q)) if len(a) else 0.0
    return WorkloadProfile(
        threshold_mb=threshold_mb,
        small_count=int((cls == SMALL).sum()),
        large_count=int((cls == LARGE).sum()),
        invocation_ratio=float(ratio) if np.isfinite(ratio) else 0.0,
        small_mem_p99=pct(small_m, 99), large_mem_p99=pct(large_m, 99),
        small_cold_p85=pct(small_c, 85), large_cold_p85=pct(large_c, 85),
    )
