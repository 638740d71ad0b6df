"""Function-chaining workloads (paper §1.1: Xanadu / SpecFaaS motivation).

A numpy copy of ``repro.workloads.chains`` for the port, which may not
import ``repro``: the same config and seed give the identical trace under
the same numpy (pinned by ``tests/test_torch_chains.py``), and
:func:`benchmark_chained_trace` loads the benchmark's trace as the
reference draws it under numpy 2.0.

Serverless workflows invoke functions in chains (A -> B -> C ...); losing
B's warm container mid-chain cascades cold starts down the chain.  This
generator emits chained traces: each chain head arrival spawns the rest of
the chain at offsets equal to the predecessors' (warm) service times.

Beyond-paper experiment: KiSS's isolation should protect chain locality —
measured as the *chain-complete latency* (sum of member latencies).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..core.types import Trace
from .azure import _quant


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    n_chains: int = 40          # distinct chain templates
    chain_len: int = 4
    arrivals_rps: float = 1.0   # chain-head arrival rate
    duration_s: float = 3600.0
    # member properties: mostly small functions, one large "analytics"
    # stage per chain with probability large_stage_prob
    small_size_range: tuple[int, int] = (30, 60)
    large_size_range: tuple[int, int] = (300, 400)
    large_stage_prob: float = 0.3
    warm_med: float = 0.4
    cold_med_small: float = 4.0
    cold_med_large: float = 15.0
    seed: int = 0


def chained_trace(cfg: ChainConfig) -> Trace:
    """Chained trace with first-class chain metadata.

    ``chain_id`` is the per-*instance* id (one per head arrival, in head
    order — NOT the template id: two arrivals of the same template are
    distinct chains with their own deadlines), ``stage`` the 0-based
    position within the chain and ``chain_len`` the instance's total
    stage count, so ``Trace.has_chains`` is True and the engines can
    account end-to-end latency per chain instance.
    """
    rng = np.random.default_rng(cfg.seed)
    # chain templates: member function ids, sizes, classes
    sizes, clss = [], []
    for c in range(cfg.n_chains):
        has_large = rng.random() < cfg.large_stage_prob
        large_at = rng.integers(0, cfg.chain_len) if has_large else -1
        for m in range(cfg.chain_len):
            if m == large_at:
                sizes.append(rng.integers(*cfg.large_size_range))
                clss.append(1)
            else:
                sizes.append(rng.integers(cfg.small_size_range[0],
                                          cfg.small_size_range[1] + 1))
                clss.append(0)
    sizes = np.asarray(sizes, np.float32)
    clss = np.asarray(clss, np.int32)

    n_arr = rng.poisson(cfg.arrivals_rps * cfg.duration_s)
    heads = np.sort(rng.uniform(0, cfg.duration_s, n_arr))
    chain_ids = rng.integers(0, cfg.n_chains, n_arr)

    ts, fids, szs, cls_, warms, colds = [], [], [], [], [], []
    cids, stages = [], []
    for inst, (t0, c) in enumerate(zip(heads, chain_ids)):
        t = t0
        for m in range(cfg.chain_len):
            fid = int(c * cfg.chain_len + m)
            warm = max(float(_quant(rng.lognormal(np.log(cfg.warm_med),
                                                  0.6))), 1 / 64)
            cm = cfg.cold_med_large if clss[fid] else cfg.cold_med_small
            cold = warm + max(float(_quant(rng.lognormal(np.log(cm), 0.8))),
                              1 / 64)
            ts.append(_quant(t)); fids.append(fid)
            szs.append(sizes[fid]); cls_.append(clss[fid])
            warms.append(warm); colds.append(cold)
            cids.append(inst); stages.append(m)
            t += warm  # next stage fires after this one's warm runtime
    order = np.argsort(np.asarray(ts), kind="stable")
    return Trace(
        t=np.asarray(ts, np.float32)[order],
        func_id=np.asarray(fids, np.int32)[order],
        size_mb=np.asarray(szs, np.float32)[order],
        cls=np.asarray(cls_, np.int32)[order],
        warm_dur=np.asarray(warms, np.float32)[order],
        cold_dur=np.asarray(colds, np.float32)[order],
        chain_id=np.asarray(cids, np.int32)[order],
        stage=np.asarray(stages, np.int32)[order],
        chain_len=np.full(len(ts), cfg.chain_len, np.int32),
    )


#: ``chained_trace(ChainConfig(duration_s=1800.0, arrivals_rps=1.0,
#: seed=0))`` (the chain benchmark's trace: 7,076 invocations in 1,769
#: chains) as the reference draws it under numpy 2.0, stored as its nine
#: arrays.
BENCHMARK_CHAINED_FILE = Path(__file__).with_name("chained_seed0_1800s.npz")


def benchmark_chained_trace() -> Trace:
    """The chain benchmark's trace, loaded from
    :data:`BENCHMARK_CHAINED_FILE`.

    ``chained_trace`` draws with ``poisson``, ``uniform``, ``integers``
    and ``lognormal``, whose streams numpy does not promise to keep
    across versions; the stored arrays are the same under every numpy,
    so a run anywhere can be held to the reference's results on this
    trace (pinned by ``tests/test_torch_chains.py``)."""
    with np.load(BENCHMARK_CHAINED_FILE) as z:
        return Trace(**{f: z[f] for f in Trace._fields})
