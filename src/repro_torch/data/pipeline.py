"""Token data pipeline; port of ``repro.data.pipeline``, the same numpy
code, so that its batches are bitwise the reference's under the same
numpy.

Offline container => no real corpus; we synthesize a Zipf-distributed token
stream with Markov bigram structure (so the ~100M-param example model has
actual structure to learn: loss drops well below uniform entropy), then
pack it into fixed-length training batches.  The iterator yields numpy and
the launcher copies each batch to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_bigram_modes: int = 64   # structure: each token biases the next


def synthetic_corpus(cfg: DataConfig, n_tokens: int) -> np.ndarray:
    """Markov token stream: P(t_{i+1} | t_i) mixes a Zipf marginal with a
    deterministic-ish successor map, giving learnable bigram structure."""
    rng = np.random.default_rng(cfg.seed)
    v = cfg.vocab_size
    # Zipf marginal
    ranks = np.arange(1, v + 1)
    marginal = 1.0 / ranks ** 1.1
    marginal /= marginal.sum()
    successor = rng.integers(0, v, size=v)  # preferred next token
    out = np.empty(n_tokens, np.int32)
    t = int(rng.integers(0, v))
    zipf_draws = rng.choice(v, size=n_tokens, p=marginal)
    follow = rng.random(n_tokens) < 0.5
    for i in range(n_tokens):
        t = successor[t] if follow[i] else zipf_draws[i]
        out[i] = t
    return out


def make_batch(tokens: np.ndarray, cfg: DataConfig, step: int) -> dict:
    """Pack one [B, S] batch (next-token labels) from the stream."""
    b, s = cfg.global_batch, cfg.seq_len
    need = b * (s + 1)
    start = (step * need) % max(len(tokens) - need, 1)
    window = tokens[start:start + need].reshape(b, s + 1)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    return {
        "tokens": window[:, :-1].astype(np.int32),
        "labels": window[:, 1:].astype(np.int32),
        "positions": pos,
        "seq_positions": pos.copy(),
    }


def batch_iterator(cfg: DataConfig, n_steps: int,
                   corpus_tokens: int | None = None) -> Iterator[dict]:
    n = corpus_tokens or cfg.global_batch * (cfg.seq_len + 1) * 4
    stream = synthetic_corpus(cfg, n)
    for step in range(n_steps):
        yield make_batch(stream, cfg, step)
