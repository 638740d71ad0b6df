"""The one general generator: a traffic mix's data file and a
configuration's data file in, the job's trace and its grid of lanes out.

The trace generator is a frozen numpy copy of the simulator's synthetic
edge FaaS trace (Azure Functions 2019 statistics, as the KiSS paper
describes them: small 30-60 MB and large 300-400 MB containers, Zipf
popularity, diurnal modulation, lognormal warm and cold durations, times
quantized to 1/64 s and sizes to whole MB).  A mix draws it from
``--seed`` and keeps its first ``events`` invocations, so that every
seed gives a job of the same length.

A lane is a plain dict (``node_mb``, ``small_frac``, ``unified`` per
node, ``replacement``, ``routing``, ``cloud_rtt_s``, ``cloud_cold_prob``,
``max_slots``, ``autoscale``): what the program's ``Scenario`` is built
from, and what the reference works its own state out from.  The grid is
the product of the mix's axes over the configuration's deployment.
"""
from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
_Q = 64.0
#: The edge trace's fixed parameters: request rates of the two size
#: classes, Zipf exponent, function counts and diurnal depth.
SMALL_RPS, LARGE_RPS, ZIPF_A = 2.5, 0.5, 1.15
N_SMALL_FUNCS, N_LARGE_FUNCS, DIURNAL_DEPTH = 220, 8, 0.3


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the harness's folder."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def _quant(x):
    return np.round(np.asarray(x) * _Q) / _Q


def _rates(rng, n_funcs: int, total_rps: float, zipf_a: float):
    w = np.minimum(rng.zipf(zipf_a, size=n_funcs).astype(np.float64), 1e4)
    return total_rps * w / w.sum()


def _arrivals(rng, rate: float, duration: float, depth: float):
    peak = rate * (1 + depth)
    n = rng.poisson(peak * duration)
    if n == 0:
        return np.zeros(0)
    t = np.sort(rng.uniform(0, duration, n))
    lam = rate * (1 + depth * np.sin(2 * np.pi * t / (24 * 3600.0)))
    return t[rng.uniform(0, peak, len(t)) < lam]


def edge_trace(seed: int, spec: dict) -> dict:
    """The six trace columns (``t``, ``func_id``, ``size_mb``, ``cls``,
    ``warm_dur``, ``cold_dur``) of the mix's edge trace for ``seed``:
    ``spec["duration_s"]`` of arrivals, cut to their first
    ``spec["events"]``."""
    rng = np.random.default_rng(seed)
    small_rates = _rates(rng, N_SMALL_FUNCS, SMALL_RPS, ZIPF_A)
    large_rates = _rates(rng, N_LARGE_FUNCS, LARGE_RPS, ZIPF_A)
    small_sizes = rng.integers(30, 61, N_SMALL_FUNCS)
    large_sizes = rng.integers(300, 401, N_LARGE_FUNCS)
    cols = {k: [] for k in ("t", "fid", "size", "cls", "warm", "cold")}
    for big, rates, sizes, base, warm_med, cold_med, cold_sigma in (
            (0, small_rates, small_sizes, 0, 0.5, 4.0, 1.0),
            (1, large_rates, large_sizes, 10_000, 2.0, 15.0, 1.3)):
        for i, rate in enumerate(rates):
            t = _arrivals(rng, rate, spec["duration_s"], DIURNAL_DEPTH)
            if not len(t):
                continue
            cols["t"].append(t)
            cols["fid"].append(np.full(len(t), base + i, np.int32))
            cols["size"].append(np.full(len(t), sizes[i], np.float32))
            cols["cls"].append(np.full(len(t), big, np.int32))
            cols["warm"].append(rng.lognormal(np.log(warm_med), 0.8, len(t)))
            cols["cold"].append(rng.lognormal(np.log(cold_med), cold_sigma,
                                              len(t)))
    t = np.concatenate(cols["t"])
    order = np.argsort(t, kind="stable")
    warm = np.maximum(_quant(np.concatenate(cols["warm"])), 1 / _Q)
    extra = np.maximum(_quant(np.concatenate(cols["cold"])), 1 / _Q)
    trace = {"t": _quant(t)[order].astype(np.float32),
             "func_id": np.concatenate(cols["fid"])[order],
             "size_mb": np.concatenate(cols["size"])[order],
             "cls": np.concatenate(cols["cls"])[order],
             "warm_dur": warm[order].astype(np.float32),
             "cold_dur": (warm + extra)[order].astype(np.float32)}
    n = spec["events"]
    if len(trace["t"]) < n:
        raise ValueError(f"seed {seed} drew {len(trace['t'])} events, "
                         f"fewer than the mix's {n}")
    return head(trace, n)


def head(trace: dict, n: int) -> dict:
    return {k: v[:n] for k, v in trace.items()}


def lanes(config: dict, mix: dict) -> list[dict]:
    """The grid of lanes: every combination of the mix's axes over the
    configuration's deployment.

    A single-node deployment (``"nodes": 1``) takes its memory from the
    ``memory_gb`` axis; a cluster gives ``node_mb`` itself.  The
    ``small_frac`` axis sets every node's split; ``replacement`` and
    ``routing`` name policies; ``baseline`` adds one unified lane for
    each memory and policy; ``autoscale`` (a dict) re-splits every lane
    after each epoch."""
    grid = mix["grid"]
    base = {"replacement": "lru", "routing": "sticky",
            "cloud_rtt_s": config["cloud_rtt_s"],
            "cloud_cold_prob": config["cloud_cold_prob"],
            "max_slots": config["max_slots"],
            "autoscale": grid.get("autoscale")}
    if "node_mb" in config:
        mems = [None]
    else:
        mems = [gb * 1024.0 for gb in grid["memory_gb"]]
    policies = grid.get("replacement", ["lru"])
    routings = grid.get("routing", ["sticky"])

    def nodes(mb):
        mb_list = config["node_mb"] if mb is None else [mb] * config["nodes"]
        return [float(m) for m in mb_list]
    out = []
    for mb, frac, rt, pol in itertools.product(
            mems, grid["small_frac"], routings, policies):
        node_mb = nodes(mb)
        out.append({**base, "node_mb": node_mb,
                    "small_frac": [float(frac)] * len(node_mb),
                    "unified": [False] * len(node_mb),
                    "replacement": pol, "routing": rt})
    if grid.get("baseline"):
        for mb, rt, pol in itertools.product(mems, routings, policies):
            node_mb = nodes(mb)
            out.append({**base, "node_mb": node_mb,
                        "small_frac": [0.8] * len(node_mb),
                        "unified": [True] * len(node_mb),
                        "replacement": pol, "routing": rt})
    return out


def check_sample(grid: list[dict], n: int, seed: int) -> list[int]:
    """The lanes the reference checks, drawn from ``seed``: every value
    of every swept parameter is held by at least one of them (so each
    policy, each split and each memory is checked in every run), then
    the rest at random, up to ``n`` (or the whole grid)."""
    rng = np.random.default_rng([seed, 0x5EED])
    order = [int(i) for i in rng.permutation(len(grid))]

    def keys(lane):
        return {(k, json.dumps(v, sort_keys=True))
                for k, v in lane.items()}
    swept = set().union(*(keys(l) for l in grid))
    common = set.intersection(*(keys(l) for l in grid))
    todo = swept - common
    pick = []
    for i in order:
        new = keys(grid[i]) & todo
        if new:
            pick.append(i)
            todo -= new
    for i in order:
        if len(pick) >= n:
            break
        if i not in pick:
            pick.append(i)
    return sorted(pick)
