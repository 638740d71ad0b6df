"""Application-level memory data for the Eq.(1) function-memory estimation
(paper §2.5.1 / Fig 2); a numpy copy of ``repro.workloads.apps``.

The Azure 2019 dataset reports *application* memory; the paper derives
function memory as  AppMemory * FuncDuration / AppDuration.  We synthesize an
app population with the same bimodal footprint structure and run the exact
estimation pipeline over it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.analyzer import estimate_function_memory


@dataclasses.dataclass(frozen=True)
class AppPopulation:
    app_memory_mb: np.ndarray   # f32[A]
    app_duration: np.ndarray    # f32[A] total duration of the app's functions
    func_app: np.ndarray        # i32[F] app index per function
    func_duration: np.ndarray   # f32[F]

    def function_memory(self) -> np.ndarray:
        return estimate_function_memory(
            self.app_memory_mb[self.func_app],
            self.func_duration,
            self.app_duration[self.func_app])


def synthesize_apps(n_apps: int = 500, seed: int = 0,
                    large_frac: float = 0.15) -> AppPopulation:
    """Bimodal app memory: ~85% small apps (lognormal, median ~120 MB,
    98th pct below ~225 MB per function) and ~15% large (300-500 MB)."""
    rng = np.random.default_rng(seed)
    is_large = rng.random(n_apps) < large_frac
    app_mem = np.where(
        is_large,
        rng.uniform(350, 550, n_apps),
        rng.lognormal(np.log(110), 0.30, n_apps)).astype(np.float32)
    n_funcs_per_app = rng.integers(1, 6, n_apps)
    func_app = np.repeat(np.arange(n_apps), n_funcs_per_app).astype(np.int32)
    n_funcs = len(func_app)
    func_dur = rng.lognormal(np.log(1.0), 0.9, n_funcs).astype(np.float32)
    # app duration = sum of its functions' durations (functions of an app
    # run as a chain), so Eq 1 apportions app memory by time share.
    app_dur = np.zeros(n_apps, np.float32)
    np.add.at(app_dur, func_app, func_dur)
    return AppPopulation(app_memory_mb=app_mem, app_duration=app_dur,
                         func_app=func_app, func_duration=func_dur)
