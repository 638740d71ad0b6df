"""Rotary position embeddings, port of ``repro.models.rope``: standard
RoPE and Qwen2-VL M-RoPE.

M-RoPE (arXiv:2409.12191): the head_dim/2 rotary frequency bands are split
into three contiguous sections (temporal, height, width); each section
rotates by the corresponding component of a 3-D position id.  Text tokens
carry (t, t, t) so M-RoPE degenerates to 1-D RoPE for them.
"""
from __future__ import annotations

import torch

from .._device import resolve_device


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """f32[head_dim//2] inverse frequencies, computed in f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 1e4,
                mrope_sections: tuple[int, int, int] | None = None
                ) -> torch.Tensor:
    """Angles f32[..., head_dim//2].

    ``positions``: i32[...] for 1-D RoPE, or i32[..., 3] (t, h, w) when
    ``mrope_sections`` is given.
    """
    inv = rope_freqs(head_dim, theta, positions.device)
    if mrope_sections is None:
        return positions.float()[..., None] * inv
    if positions.shape[-1] != 3:
        raise ValueError("M-RoPE positions must be [..., 3]")
    sec = torch.tensor(sum(([i] * s for i, s in enumerate(mrope_sections)),
                           []), dtype=torch.long, device=positions.device)
    if sec.shape[0] != head_dim // 2:
        raise ValueError("mrope sections must sum to half the head dim")
    pos_per_band = positions.index_select(-1, sec)   # [..., half]
    return pos_per_band.float() * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :half], x[..., half:]); cos/sin in f32, cast
    to x's dtype before the rotation.

    x: [..., n_heads, head_dim]; angles: [...,(broadcast), head_dim//2].
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = torch.cos(angles).to(x.dtype)[..., None, :]
    s = torch.sin(angles).to(x.dtype)[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def text_positions(batch: int, seq: int, offset=0,
                   device=None) -> torch.Tensor:
    """i32[1, seq]: ``offset .. offset + seq - 1`` (broadcasts over the
    batch, as the reference's does), on ``device`` (CUDA unless
    ``"cpu"``)."""
    return torch.arange(seq, dtype=torch.int32,
                        device=resolve_device(device))[None] + offset


def mrope_text_positions(batch: int, seq: int, offset=0,
                         device=None) -> torch.Tensor:
    """Text-only M-RoPE positions: (t, t, t), i32[batch, seq, 3]."""
    p = text_positions(batch, seq, offset, device)
    return p[..., None].expand(batch, seq, 3)
