"""Step functions (train / prefill / decode); port of the raw steps of
``repro.launch.steps``.

The reference also binds each step into a ``jax.jit`` with shardings on
a mesh (``_shard``, ``make_sharded_train_step``, ``make_sharded_prefill``,
``make_sharded_decode``, ``make_step_for``); those belong to launch and
sharding (ROADMAP A18) and are not ported yet.  Here a step runs on the
device its params lie on.
"""
from __future__ import annotations

import torch

from .._tree import tree_leaves, tree_map, tree_unflatten
from ..models import decode_step as model_decode
from ..models import loss_fn, prefill as model_prefill
from ..models.config import ModelConfig
from ..optim import Optimizer, get_optimizer


def train_step(cfg: ModelConfig, optimizer: Optimizer, params, opt_state,
               batch, *, remat: bool = True):
    """One step: the loss and the grads of every param leaf (by
    ``torch.autograd.grad``; a leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives it), then ``optimizer.update``.  Returns (new
    params, new optimizer state, metrics), the metrics detached."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        total, metrics = loss_fn(cfg, live, batch, remat=remat)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])
    del live, leaves
    new_params, new_opt = optimizer.update(params, grads, opt_state)
    return new_params, new_opt, {k: v.detach() for k, v in metrics.items()}


def prefill_step(cfg: ModelConfig, params, batch, *, cache_len: int,
                 window: int | None):
    return model_prefill(cfg, params, batch, cache_len=cache_len,
                         window=window)


def decode_step(cfg: ModelConfig, params, batch, caches, *,
                window: int | None):
    return model_decode(cfg, params, batch, caches, window=window)


def default_optimizer(cfg: ModelConfig) -> Optimizer:
    """Adafactor for the trillion-param MoE (factored second moments are
    the only state that fits), AdamW elsewhere."""
    if cfg.param_count() > 100e9:
        return get_optimizer("adafactor", lr=1e-3)
    return get_optimizer("adamw", lr=3e-4)
