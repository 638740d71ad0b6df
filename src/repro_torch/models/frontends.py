"""Modality frontends, stubs as in the reference; port of
``repro.models.frontends``.

The audio conv feature extractor (whisper) and the vision tower and
projector (qwen2-vl) are not implemented in either package; these helpers
make stand-in frame and patch embeddings of the right shape and scale for
smoke runs and examples.  They draw from an explicit ``torch.Generator``
on ``device`` (the generator's device by default), so their numbers
differ from the reference's ``jax.random`` ones; the shapes, the scale
and the positions are the reference's.
"""
from __future__ import annotations

import torch

from .config import ModelConfig


def _draw(gen, shape, dtype, device) -> torch.Tensor:
    device = gen.device if device is None else device
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype) * 0.02


def stub_audio_frames(gen, cfg: ModelConfig, batch: int,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """What whisper's two conv layers would emit: [B, S_enc, D]."""
    return _draw(gen, (batch, cfg.encoder_seq, cfg.d_model), dtype, device)


def stub_vision_patches(gen, cfg: ModelConfig, batch: int, n_patches: int,
                        seq_len: int, dtype=torch.float32, device=None):
    """What the ViT and projector would emit: patch embeddings [B, P, D];
    the positions in the token sequence where they are spliced, i32
    [B, P] (the first P); and 3-D M-RoPE position ids i32 [B, S, 3]: the
    patches share temporal index 0 on a (h, w) grid of side
    ``floor(sqrt(P))``, and text resumes after the patch span at
    ``t - P + 1`` in all three."""
    emb = _draw(gen, (batch, n_patches, cfg.d_model), dtype, device)
    dev = emb.device
    patch_positions = torch.arange(n_patches, dtype=torch.int32,
                                   device=dev)[None].expand(batch, n_patches)
    side = max(int(n_patches ** 0.5), 1)
    t = torch.arange(seq_len, dtype=torch.int32, device=dev)
    in_patch = t < n_patches
    tt = torch.where(in_patch, 0, t - n_patches + 1)
    hh = torch.where(in_patch, t // side, tt)
    ww = torch.where(in_patch, t % side, tt)
    pos = torch.stack([tt, hh, ww], dim=-1).to(torch.int32)
    return emb, patch_positions, pos[None].expand(batch, seq_len, 3)
