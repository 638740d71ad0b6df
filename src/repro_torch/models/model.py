"""Unified model facade, port of ``repro.models.model``: one API across
the decoder-only families (``transformer``) and the whisper
encoder-decoder (``whisper``).

``batch`` dict keys by arch family:
  text/moe/ssm/hybrid: tokens [B,S], positions [B,S], seq_positions [B,S]
  vlm:   + patch_embeds [B,P,D], patch_positions [B,P], positions [B,S,3]
  audio: frame_embeds [B,S_enc,D], tokens [B,S] (decoder), positions [B,S]
and, for ``loss_fn``, labels i32 [B,S] (a negative label is masked out).
"""
from __future__ import annotations

import torch

from . import transformer, whisper
from .config import ModelConfig


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    if cfg.is_encoder_decoder:
        return whisper.init_params(cfg, seed, device)
    return transformer.init_params(cfg, seed, device)


def forward_train(cfg: ModelConfig, params, batch, *, remat: bool = True,
                  rows=None):
    """-> (logits [B,S,V] fp32, Aux).  Whisper ignores ``remat``, as the
    reference does; ``rows``: see :func:`loss_fn`."""
    if cfg.is_encoder_decoder:
        logits = whisper.decode_train(cfg, params, batch["frame_embeds"],
                                      batch["tokens"])
        return logits, transformer._zero_aux(logits)
    return transformer.forward_train(cfg, params, batch, remat=remat,
                                     rows=rows)


def loss_fn(cfg: ModelConfig, params, batch, *, remat: bool = True,
            rows=None):
    """Cross-entropy LM loss (+ MoE aux): (total, {"loss", "moe_aux",
    "router_entropy"}), all f32 scalars.  The loss is the mean over the
    positions whose label is not negative: their summed negative
    log-likelihood over their count.

    ``rows``, where ``batch`` is this rank's equal part of a batch split
    across ranks (a sharded step, ``launch.steps``): their count
    ``rows.ranks`` and ``rows.sum(t)``, which adds ``t`` over them in
    place.  The count is then the whole batch's, and each value is this
    rank's share: the ranks' values add up to the whole batch's."""
    logits, aux = forward_train(cfg, params, batch, remat=remat, rows=rows)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    # a masked label reads row 0; its term is multiplied by 0
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    count = mask.sum() if rows is None else rows.sum(mask.sum())
    loss = (nll * mask).sum() / torch.clamp(count, min=1.0)
    total = loss + cfg.router_aux_coef * aux.moe_aux
    return total, {"loss": loss, "moe_aux": aux.moe_aux,
                   "router_entropy": aux.router_entropy}


def prefill(cfg: ModelConfig, params, batch, *, cache_len: int,
            window: int | None = None):
    if cfg.is_encoder_decoder:
        return whisper.prefill(cfg, params, batch["frame_embeds"],
                               batch["tokens"], cache_len=cache_len,
                               window=window)
    return transformer.prefill(cfg, params, batch, cache_len=cache_len,
                               window=window)


def decode_step(cfg: ModelConfig, params, batch, caches, *,
                window: int | None = None):
    if cfg.is_encoder_decoder:
        return whisper.decode_step(cfg, params, batch["tokens"],
                                   batch["positions"], caches, window=window)
    return transformer.decode(cfg, params, batch, caches, window=window)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, window: int | None = None,
                device=None):
    if cfg.is_encoder_decoder:
        return whisper.init_whisper_caches(cfg, batch, max_len, dtype,
                                           window=window, device=device)
    return transformer.init_caches(cfg, batch, max_len, dtype,
                                   window=window, device=device)
