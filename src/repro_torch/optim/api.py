"""Uniform optimizer facade: ``get_optimizer("adamw"|"adafactor")``; port
of ``repro.optim.api``."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

from .adafactor import adafactor_init, adafactor_update
from .adamw import adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def get_optimizer(name: str, **kwargs) -> Optimizer:
    if name == "adamw":
        return Optimizer("adamw", adamw_init,
                         functools.partial(adamw_update, **kwargs))
    if name == "adafactor":
        return Optimizer("adafactor", adafactor_init,
                         functools.partial(adafactor_update, **kwargs))
    raise KeyError(name)
