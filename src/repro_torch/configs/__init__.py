"""Assigned-architecture registry: ``get_config("<arch-id>")``.

A copy of ``repro.configs`` (the ten config modules are data, copied
as they are), so both packages name the same ids and hyperparameters.

Every entry cites its source (paper / model card) in the module docstring
and ``ModelConfig.source``.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = [
    "granite-34b",
    "kimi-k2-1t-a32b",
    "whisper-medium",
    "qwen2-vl-7b",
    "qwen2.5-32b",
    "glm4-9b",
    "granite-moe-1b-a400m",
    "starcoder2-3b",
    "zamba2-1.2b",
    "rwkv6-7b",
]

_MODULES = {
    "granite-34b": "granite_34b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "whisper-medium": "whisper_medium",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "glm4-9b": "glm4_9b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "starcoder2-3b": "starcoder2_3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "rwkv6-7b": "rwkv6_7b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
