"""Optimizers of the port (functional, over the params' nested dicts and
lists of tensors); port of ``repro.optim``."""
from .adafactor import AdafactorState, adafactor_init, adafactor_update
from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .api import Optimizer, get_optimizer

__all__ = ["adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "Optimizer", "get_optimizer"]
