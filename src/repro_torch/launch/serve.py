"""Serving entry point: an edge node running the KiSS-managed
multi-model pool; port of ``repro.launch.serve``.

Reduced-config registry, real cold starts (weights on the device plus a
warm-up).  Replays a workload of model requests through the Batcher and
reports the paper's metrics (cold-start %, drop %, per-class) measured on
real containers.  Runs on the CUDA device unless ``--device cpu``.  The
default registry (``--n-archs 4``) mixes the dense, SSM and hybrid
families: reduced starcoder2-3b, rwkv6-7b, zamba2-1.2b and glm4-9b::

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

``--n-archs 5`` adds qwen2.5-32b (dense) and ``--n-archs 6``
granite-moe-1b-a400m (MoE)::

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n-archs 6
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config
from ..core.types import Policy
from ..serving import Batcher, KissServer, Request, UnifiedServer


def default_registry(n_archs: int = 6) -> dict:
    """Reduced variants of N assigned archs (mixed families).  Ordered so
    the SMALL models are the popular ones (requests are Zipf over this
    order) — the paper's workload shape: small = high-frequency, large =
    infrequent but expensive."""
    picks = ["starcoder2-3b", "rwkv6-7b", "zamba2-1.2b", "glm4-9b",
             "qwen2.5-32b", "granite-moe-1b-a400m"][:n_archs]
    return {a: get_config(a).reduced() for a in picks}


def synthesize_requests(registry: dict, n: int, seed: int = 0,
                        small_bias: float = 0.8) -> list[Request]:
    """Zipf-ish model popularity: first models get most traffic (the
    small/large frequency asymmetry of the paper's workload analysis)."""
    rng = np.random.default_rng(seed)
    models = list(registry)
    w = 1.0 / np.arange(1, len(models) + 1) ** 1.2
    w /= w.sum()
    out = []
    for i in range(n):
        m = models[int(rng.choice(len(models), p=w))]
        toks = rng.integers(0, registry[m].vocab_size, 12).astype(np.int32)
        out.append(Request(m, toks, n_new=4, arrival=float(i)))
    return out


def run(server, registry, requests, max_batch: int = 2) -> dict:
    b = Batcher(server, max_batch=max_batch)
    lat = {"hit": [], "miss": [], "drop": []}
    t0 = time.perf_counter()
    for i, r in enumerate(requests):
        b.enqueue(r)
        if (i + 1) % max_batch == 0:
            for done in b.drain():
                lat[done.result.status].append(done.result.latency_s)
    for done in b.drain():
        lat[done.result.status].append(done.result.latency_s)
    wall = time.perf_counter() - t0
    o = server.stats.small + server.stats.large
    return {
        "total": o.total_accesses,
        "cold_start_pct": o.cold_start_pct,
        "drop_pct": o.drop_pct,
        "hit_rate": o.hit_rate,
        "mean_warm_ms": 1e3 * float(np.mean(lat["hit"])) if lat["hit"] else 0,
        "mean_cold_ms": 1e3 * float(np.mean(lat["miss"])) if lat["miss"] else 0,
        "wall_s": wall,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--total-mb", type=float, default=120.0)
    ap.add_argument("--threshold-mb", type=float, default=8.0)
    ap.add_argument("--n-archs", type=int, default=4)
    ap.add_argument("--policy", default="LRU",
                    choices=["LRU", "GREEDY_DUAL", "FREQ"])
    ap.add_argument("--baseline", action="store_true",
                    help="unified pool instead of KiSS")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    registry = default_registry(args.n_archs)
    ckw = dict(max_batch=2, max_len=64, device=args.device)
    cls = UnifiedServer if args.baseline else KissServer
    kw = dict(total_mb=args.total_mb, threshold_mb=args.threshold_mb,
              policy=Policy[args.policy], container_kwargs=ckw)
    if not args.baseline:
        kw["small_frac"] = 0.8
    server = cls(registry, **kw)
    reqs = synthesize_requests(registry, args.requests)
    stats = run(server, registry, reqs)
    name = "baseline(unified)" if args.baseline else "KiSS(80-20)"
    print(f"[{name}] {stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
