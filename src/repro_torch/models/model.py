"""Unified model facade, port of ``repro.models.model``: one API across
the model families.  The dense, hybrid (zamba2) and SSM (rwkv6) decoder
stacks are ported; MoE, VLM and encoder-decoder (whisper) raise at init
naming their ROADMAP item (``transformer.check_supported``)."""
from __future__ import annotations

import torch

from . import transformer
from .config import ModelConfig


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    return transformer.init_params(cfg, seed, device)


def forward_train(cfg: ModelConfig, params, batch):
    """-> (logits [B,S,V] fp32, Aux)."""
    return transformer.forward_train(cfg, params, batch)


def prefill(cfg: ModelConfig, params, batch, *, cache_len: int,
            window: int | None = None):
    return transformer.prefill(cfg, params, batch, cache_len=cache_len,
                               window=window)


def decode_step(cfg: ModelConfig, params, batch, caches, *,
                window: int | None = None):
    return transformer.decode(cfg, params, batch, caches, window=window)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, window: int | None = None,
                device=None):
    return transformer.init_caches(cfg, batch, max_len, dtype,
                                   window=window, device=device)
