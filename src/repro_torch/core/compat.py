"""Deprecation helper for the legacy simulator entrypoints (a copy of
``repro.core.compat``).

The scenario-based front door (``repro_torch.sim``) supersedes the
``simulate_*`` / ``sweep_*`` functions of ``repro_torch.core`` and
``repro_torch.cluster``.  The old names keep working: each is a thin
shim that emits a :class:`DeprecationWarning` and forwards, so
downstream code migrates at its own pace.
"""
from __future__ import annotations

import functools
import warnings


def deprecated(replacement: str):
    """Wrap an entrypoint so calling it warns and forwards unchanged.

    ``replacement`` is the human-readable new spelling, e.g.
    ``"repro_torch.sim.simulate(Scenario.kiss(...))"``.
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            warnings.warn(
                f"{fn.__name__} is deprecated; use {replacement} instead",
                DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        wrapper.__deprecated__ = replacement
        return wrapper

    return deco
