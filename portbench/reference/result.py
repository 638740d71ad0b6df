"""What the front door reports of one lane, worked out from the
reference's per-event nodes and outcomes: the latency of every
invocation, the per-node and per-class counts and execution time, and
the summary numbers, each computed in the same order and precision as
the published result contract (float64 sums of float32 inputs)."""
from __future__ import annotations

import numpy as np

from .pool import DROP, HIT, MISS


def cloud_cold(n: int, prob: float, rng_seed: int) -> np.ndarray:
    """The cloud's cold starts, one coin an event, drawn from the run's
    seed (the same draws for every lane of one probability)."""
    return np.random.default_rng(rng_seed).random(n) < prob


def _class_row(row) -> dict:
    hits, misses, drops = int(row[0]), int(row[1]), int(row[2])
    return {"hits": hits, "misses": misses, "drops": drops,
            "exec": float(row[3]), "n": hits + misses + drops}


def _pct(a: int, n: int) -> float:
    return 100.0 * a / n if n else 0.0


def price(lane: dict, trace: dict, node, outcome, rng_seed: int,
          fracs=None, active=None) -> dict:
    """``latencies`` f64[T], ``per_node`` f64[N, 2, 4] (hits, misses,
    drops, edge execution seconds a node and class) and ``summary``."""
    n_nodes = len(lane["node_mb"])
    node = np.asarray(node, np.int64)
    outcome = np.asarray(outcome, np.int64)
    cls = np.asarray(trace["cls"], np.int64)
    warm = np.asarray(trace["warm_dur"], np.float64)
    cold = np.asarray(trace["cold_dur"], np.float64)
    coin = cloud_cold(len(outcome), lane["cloud_cold_prob"], rng_seed)
    lat = np.where(outcome == HIT, warm, np.where(
        outcome == MISS, cold,
        lane["cloud_rtt_s"] + np.where(coin, cold, warm)))
    per_node = np.zeros((n_nodes, 2, 4), np.float64)
    np.add.at(per_node, (node, cls, outcome), 1.0)
    edge = np.where(outcome == HIT, warm,
                    np.where(outcome == MISS, cold, 0.0))
    np.add.at(per_node, (node, cls, np.full_like(node, 3)), edge)
    agg = per_node.sum(axis=0)
    small, large = _class_row(agg[0]), _class_row(agg[1])
    hits = small["hits"] + large["hits"]
    misses = small["misses"] + large["misses"]
    total = small["n"] + large["n"]
    exec_s = small["exec"] + large["exec"]
    served = hits + misses
    if fracs is None:
        fracs = np.asarray([lane["small_frac"]], np.float32)
        active = np.ones((1, n_nodes), bool)
    kiss = [i for i, u in enumerate(lane["unified"]) if not u]
    fr = fracs[:, kiss] if kiss else fracs
    summary = {
        "cold_start_pct": _pct(misses, total),
        "drop_pct": _pct(small["drops"] + large["drops"], total),
        "hit_rate": _pct(hits, total),
        "small_cold_start_pct": _pct(small["misses"], small["n"]),
        "large_cold_start_pct": _pct(large["misses"], large["n"]),
        "small_drop_pct": _pct(small["drops"], small["n"]),
        "large_drop_pct": _pct(large["drops"], large["n"]),
        "serviceable": served, "total": total, "exec_time_s": exec_s,
        "serviceable_mean_s": exec_s / served if served else 0.0,
        "n_nodes": n_nodes,
        "offload_pct": _pct(int((outcome == DROP).sum()), len(lat)),
        "latency_mean_s": float(lat.mean()),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p95_s": float(np.percentile(lat, 95)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "n_epochs": int(fr.shape[0]),
        "frac_final_mean": float(fr[-1].mean()),
        "frac_min": float(fr.min()), "frac_max": float(fr.max()),
        "n_active_final": int(active[-1].sum()),
        "n_active_min": int(active.sum(axis=1).min()),
    }
    return {"latencies": lat, "per_node": per_node, "summary": summary}
