"""Input specifications: ``meta`` tensors standing in for every model
input, per (architecture x input shape); port of ``repro.launch.specs``.
They have each input's shape and dtype and allocate nothing.

``long_500k`` policy: sub-quadratic attention is required — SSM/hybrid
archs run natively (O(1)/token state); full-attention archs run the
sliding-window variant (ring-buffer KV cache of LONG_CONTEXT_WINDOW
slots).  whisper-medium takes it too (windowed decoder) but the shape is
flagged as shape-proving only (the model caps at 448 decoder positions).
"""
from __future__ import annotations

from typing import Any

import torch

from ..models import init_caches, init_params
from ..models.config import INPUT_SHAPES, InputShape, ModelConfig

LONG_CONTEXT_WINDOW = 4096
VLM_PATCHES = 256

F32 = torch.float32
I32 = torch.int32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def decode_window(cfg: ModelConfig, shape: InputShape) -> int | None:
    """Ring-buffer window for decode shapes (None = full cache)."""
    if shape.name != "long_500k":
        return cfg.sliding_window
    if cfg.arch_type in ("ssm",):
        return None                      # no attention cache at all
    # hybrid zamba2: window the shared attention block; dense/moe/vlm/audio:
    # the sliding-window variant.
    return min(cfg.sliding_window or LONG_CONTEXT_WINDOW,
               LONG_CONTEXT_WINDOW)


def batch_specs_for(cfg: ModelConfig, shape: InputShape) -> dict[str, Any]:
    """``meta`` tensors for the step's ``batch`` argument."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    batch: dict[str, Any] = {
        "tokens": _meta((b, s), I32),
        "positions": _meta((b, s), I32),
        "seq_positions": _meta((b, s), I32),
    }
    if cfg.arch_type == "vlm":
        batch["positions"] = _meta((b, s, 3), I32)
        if shape.kind != "decode":
            batch["patch_embeds"] = _meta((b, VLM_PATCHES, cfg.d_model), F32)
            batch["patch_positions"] = _meta((b, VLM_PATCHES), I32)
    if cfg.is_encoder_decoder and shape.kind != "decode":
        batch["frame_embeds"] = _meta((b, cfg.encoder_seq, cfg.d_model), F32)
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), I32)
    return batch


def cache_specs_for(cfg: ModelConfig, shape: InputShape):
    """``meta`` decode-time caches (as if seq_len tokens were already
    prefilled), one a layer."""
    if shape.kind != "decode":
        raise ValueError(f"{shape.name} is a {shape.kind} shape, not decode")
    return init_caches(cfg, shape.global_batch, shape.seq_len,
                       dtype=torch.bfloat16, window=decode_window(cfg, shape),
                       device="meta")


def params_shapes_for(cfg: ModelConfig):
    return init_params(cfg, device="meta")


def describe(cfg: ModelConfig, shape: InputShape) -> str:
    notes = []
    if shape.name == "long_500k":
        win = decode_window(cfg, shape)
        if cfg.arch_type == "ssm":
            notes.append("native O(1) state (attention-free)")
        elif cfg.arch_type == "hybrid":
            notes.append(f"mamba state native; shared-attn windowed {win}")
        else:
            notes.append(f"sliding-window {win} ring cache")
        if cfg.is_encoder_decoder:
            notes.append("shape-proving only (whisper caps at 448 positions)")
    return "; ".join(notes)
