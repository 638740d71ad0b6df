"""Whisper-style encoder-decoder backbone (arXiv:2212.04356); port of
``repro.models.whisper``.

As in the reference, the mel-spectrogram and conv feature extractor is a
stub: the caller gives frame embeddings [B, S_enc, D] (what the two conv
layers would emit; ``frontends.stub_audio_frames``).  This module is
everything after that: sinusoidal encoder positions, a bidirectional
encoder, and a causal decoder with learned positions and a
cross-attention per layer.  The reference scans stacked layer params;
here ``enc_layers`` and ``dec_layers`` are lists of per-layer dicts and
the stacks are Python loops, and the cache holds one ``KVCache`` and one
cross k/v pair per decoder layer.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .attention import (attention_decode, attention_prefill, attn_init,
                        cross_attention, encode_cross_kv, init_cache)
from .config import ModelConfig
from .layers import _dtype, _normal, embed, embedding_init, mlp, mlp_init, \
    norm, norm_init
from .transformer import _device


class WhisperCache(NamedTuple):
    self_caches: Any     # KVCache per decoder layer
    cross_k: Any         # [B, S_enc, H, hd] per decoder layer
    cross_v: Any


def _sinusoid(seq: int, d: int, device="cpu") -> torch.Tensor:
    """f32 [seq, d]: sin then cos of ``pos / 10000 ** (2 i / d)``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (torch.tensor(10000.0, device=device) ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln(cfg: ModelConfig, device) -> dict:
    return norm_init(cfg.d_model, "layernorm", "float32", device=device)


def _enc_layer_init(gen, cfg: ModelConfig, device) -> dict:
    return {"ln1": _ln(cfg, device),
            "attn": attn_init(gen, cfg, device=device),
            "ln2": _ln(cfg, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", cfg.dtype,
                            device=device)}


def _dec_layer_init(gen, cfg: ModelConfig, device) -> dict:
    return {"ln1": _ln(cfg, device),
            "attn": attn_init(gen, cfg, device=device),
            "ln_x": _ln(cfg, device),
            "xattn": attn_init(gen, cfg, device=device),
            "ln2": _ln(cfg, device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", cfg.dtype,
                            device=device)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random weights in ``cfg.dtype`` (norms in f32) from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (CUDA unless
    ``"cpu"``; ``"meta"`` gives shapes and dtypes without allocating)."""
    dev = _device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    d = cfg.d_model
    max_tgt = cfg.max_target_positions or 448
    return {
        "tok_embed": embedding_init(gen, cfg.vocab_size, d, cfg.dtype,
                                    device=dev),
        "pos_embed": _normal(gen, (max_tgt, d), 0.01, cfg.dtype, dev),
        "enc_layers": [_enc_layer_init(gen, cfg, dev)
                       for _ in range(cfg.n_encoder_layers)],
        "enc_norm": _ln(cfg, dev),
        "dec_layers": [_dec_layer_init(gen, cfg, dev)
                       for _ in range(cfg.n_layers)],
        "dec_norm": _ln(cfg, dev),
    }


def encode(cfg: ModelConfig, params, frame_embeds: torch.Tensor
           ) -> torch.Tensor:
    """frame_embeds: [B, S_enc, D] (stub conv output) -> encoder states,
    each layer's self-attention non-causal."""
    x = frame_embeds.to(_dtype(cfg.dtype))
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    for lp in params["enc_layers"]:
        h, _ = attention_prefill(cfg, lp["attn"],
                                 norm(lp["ln1"], x, cfg.norm_eps),
                                 positions, causal=False)
        x = x + h
        x = x + mlp(lp["mlp"], norm(lp["ln2"], x, cfg.norm_eps), "gelu")
    return norm(params["enc_norm"], x, cfg.norm_eps)


def _dec_positions(tokens: torch.Tensor, offset: int = 0) -> torch.Tensor:
    b, s = tokens.shape
    return (torch.arange(s, dtype=torch.int32, device=tokens.device)[None]
            + offset).expand(b, s)


def _dec_embed(cfg, params, tokens, positions):
    """Token embeddings plus the learned positions, at ``positions``
    modulo the table's length, as the reference takes them."""
    x = embed(params["tok_embed"], tokens.long(), _dtype(cfg.dtype))
    max_tgt = params["pos_embed"].shape[0]
    return x + params["pos_embed"].to(x.dtype)[positions.long() % max_tgt]


def _head(cfg, params, x) -> torch.Tensor:
    x = norm(params["dec_norm"], x, cfg.norm_eps)
    return (x @ params["tok_embed"]["emb"].to(x.dtype).T).float()


def _dec_layer(cfg, lp, x, h, ek, ev):
    """The rest of a decoder layer after its self-attention output ``h``:
    the residual, the cross-attention, the MLP."""
    x = x + h
    x = x + cross_attention(cfg, lp["xattn"],
                            norm(lp["ln_x"], x, cfg.norm_eps), ek, ev)
    return x + mlp(lp["mlp"], norm(lp["ln2"], x, cfg.norm_eps), "gelu")


def decode_train(cfg: ModelConfig, params, frame_embeds, tokens):
    """Teacher-forced decoder pass -> logits [B, S, V] (f32)."""
    enc = encode(cfg, params, frame_embeds)
    positions = _dec_positions(tokens)
    x = _dec_embed(cfg, params, tokens, positions)
    for lp in params["dec_layers"]:
        h, _ = attention_prefill(cfg, lp["attn"],
                                 norm(lp["ln1"], x, cfg.norm_eps), positions)
        ek, ev = encode_cross_kv(cfg, lp["xattn"], enc)
        x = _dec_layer(cfg, lp, x, h, ek, ev)
    return _head(cfg, params, x)


def prefill(cfg: ModelConfig, params, frame_embeds, tokens, *,
            cache_len: int, window: int | None = None):
    """Encode the audio and prefill the decoder -> (last logits f32
    [B, 1, V], WhisperCache)."""
    enc = encode(cfg, params, frame_embeds)
    positions = _dec_positions(tokens)
    x = _dec_embed(cfg, params, tokens, positions)
    caches, cks, cvs = [], [], []
    for lp in params["dec_layers"]:
        h, c = attention_prefill(cfg, lp["attn"],
                                 norm(lp["ln1"], x, cfg.norm_eps), positions,
                                 make_cache=True, cache_len=cache_len,
                                 window_override=window)
        ek, ev = encode_cross_kv(cfg, lp["xattn"], enc)
        x = _dec_layer(cfg, lp, x, h, ek, ev)
        caches.append(c)
        cks.append(ek)
        cvs.append(ev)
    return _head(cfg, params, x[:, -1:]), WhisperCache(caches, cks, cvs)


def decode_step(cfg: ModelConfig, params, tokens, positions,
                cache: WhisperCache, *, window: int | None = None):
    """tokens: [B, 1] -> (logits f32 [B, 1, V], the cache, its self
    caches written in place)."""
    x = _dec_embed(cfg, params, tokens, positions)
    for lp, c, ek, ev in zip(params["dec_layers"], cache.self_caches,
                             cache.cross_k, cache.cross_v):
        h, _ = attention_decode(cfg, lp["attn"],
                                norm(lp["ln1"], x, cfg.norm_eps), positions,
                                c, window_override=window)
        x = _dec_layer(cfg, lp, x, h, ek, ev)
    return _head(cfg, params, x), cache


def init_whisper_caches(cfg: ModelConfig, batch: int, max_len: int,
                        dtype=torch.bfloat16, window: int | None = None,
                        device=None) -> WhisperCache:
    """Blank caches: a ``KVCache`` per decoder layer (``window`` caps it
    to a ring of that many slots) and zero cross k/v [B, S_enc, H, hd]."""
    dev = _device(device)
    eff = min(max_len, window) if window else max_len
    n = cfg.n_layers
    shape = (batch, cfg.encoder_seq, cfg.n_heads, cfg.resolved_head_dim)
    return WhisperCache(
        self_caches=[init_cache(cfg, batch, eff, dtype, device=dev)
                     for _ in range(n)],
        cross_k=[torch.zeros(shape, dtype=dtype, device=dev)
                 for _ in range(n)],
        cross_v=[torch.zeros(shape, dtype=dtype, device=dev)
                 for _ in range(n)],
    )
