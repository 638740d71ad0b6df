"""Request queue + per-model batcher; port of ``repro.serving.batcher``.

Requests accumulate in a queue; ``drain()`` groups them by model (up to the
container's max batch), right-pads prompts, and submits one batched
generation per group — continuous-batching-lite, enough to exercise KiSS
under concurrent multi-model traffic.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

import numpy as np

from .server import ServeResult, _ServerBase


@dataclasses.dataclass
class Request:
    model_id: str
    tokens: np.ndarray       # i32[S]
    n_new: int = 8
    arrival: float = 0.0
    result: Optional[ServeResult] = None


class Batcher:
    def __init__(self, server: _ServerBase, max_batch: int = 4):
        self.server = server
        self.max_batch = max_batch
        self.queue: list[Request] = []

    def enqueue(self, req: Request):
        self.queue.append(req)

    def drain(self) -> list[Request]:
        by_model: dict[str, list[Request]] = defaultdict(list)
        for r in self.queue:
            by_model[r.model_id].append(r)
        done: list[Request] = []
        for model_id, reqs in by_model.items():
            for i in range(0, len(reqs), self.max_batch):
                group = reqs[i:i + self.max_batch]
                s = max(len(r.tokens) for r in group)
                toks = np.zeros((len(group), s), np.int32)
                for j, r in enumerate(group):
                    toks[j, :len(r.tokens)] = r.tokens
                n_new = max(r.n_new for r in group)
                res = self.server.submit(model_id, toks, n_new,
                                         now=group[0].arrival)
                for j, r in enumerate(group):
                    r.result = dataclasses.replace(
                        res, tokens=(res.tokens[j:j + 1]
                                     if res.tokens is not None else None))
                done.extend(group)
        self.queue.clear()
        return done
