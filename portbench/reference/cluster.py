"""The plain reference of a configuration: an edge node, or a cluster of KiSS
or unified nodes in front of a priced cloud, one event at a time.

Each node holds two pools (a unified node: one pool of the whole node
and an empty second one).  An event goes to the pool of its size class
(pool 0 on a unified node) of the node its routing policy picks; what a
node cannot place drops to the cloud.  An autoscaled lane re-splits
every KiSS node after each full epoch from the epoch's pressure (misses
+ 2 x drops a class), moving ``gain`` of the way toward the pressured
class within ``[min_frac, max_frac]``.  Every number is rounded the way
the configuration states (``rnd``: float32; the control passes bfloat16).

The routing bodies below are the published policies, written for numpy
float32 scalars and ``[N]`` arrays.  This module imports nothing of the
program.
"""
from __future__ import annotations

import numpy as np

from .pool import DROP, MISS, Pool, f32, new_uids

F = np.float32


def _free_frac(free, cap):
    return free / np.maximum(cap, F(1e-6))


def _nth_masked(mask, j):
    return int(np.argmax(np.cumsum(mask.astype(np.int32)) == j + 1))


def _sticky(ev, free, cap, up, rtt, ccp):
    k = int(np.sum(up.astype(np.int32)))
    j = int(np.mod(ev["h1"], max(k, 1)))
    if up[ev["h1"]] or k == 0:
        return int(ev["h1"])
    return _nth_masked(up, j)


def _least_loaded(ev, free, cap, up, rtt, ccp):
    return int(np.argmax(np.where(up, _free_frac(free, cap), F(-np.inf))))


def _size_aware(ev, free, cap, up, rtt, ccp):
    elig = ((cap >= ev["size"] - F(1e-9)) & up).astype(np.int32)
    k = int(np.sum(elig))
    if k == 0:
        return int(ev["h1"])
    return _nth_masked(elig, int(np.mod(ev["h1"], k)))


def _power_of_two(ev, free, cap, up, rtt, ccp):
    frac = np.where(up, _free_frac(free, cap), F(-np.inf))
    return int(ev["h1"] if frac[ev["h1"]] >= frac[ev["h2"]] else ev["h2"])


def _cost_model(ev, free, cap, up, rtt, ccp):
    frac = _free_frac(free, cap)
    cold_cost = ev["cold"] - ev["warm"]
    edge_pred = (F(1.0) - frac) * cold_cost
    cloud_pred = rtt + ccp * cold_cost
    feasible = (cap >= ev["size"] - F(1e-9)) & up
    return int(np.argmin(np.where(feasible, edge_pred, cloud_pred)))


ROUTING = {"sticky": _sticky, "least_loaded": _least_loaded,
           "size_aware": _size_aware, "power_of_two": _power_of_two,
           "cost_model": _cost_model}
#: The policies that read the pools' free memory.
_READS_FREE = {"least_loaded", "power_of_two", "cost_model"}


def route_hashes(func_id: np.ndarray, n_nodes: int):
    """The two node hashes of each event: ``func_id mod N`` and a Knuth
    multiplicative hash mod N."""
    fid = np.asarray(func_id)
    h1 = (fid % n_nodes).astype(np.int32)
    mixed = (fid.astype(np.uint32) * np.uint32(2654435761)) >> np.uint32(16)
    return h1, (mixed % np.uint32(n_nodes)).astype(np.int32)


def pool_caps(node_mb, small_frac, unified) -> np.ndarray:
    """f64[N, 2] (small, large) capacities, rounded through float32."""
    caps = np.array([(m, 0.0) if u else (m * f, m * (1.0 - f))
                     for m, f, u in zip(node_mb, small_frac, unified)],
                    np.float64)
    return np.float32(caps).astype(np.float64)


def run_lane(lane: dict, trace: dict, rnd=f32) -> dict:
    """One lane over the trace: ``{"node", "outcome"}`` i32[T] and, for
    an autoscaled lane, ``{"fracs": f32[E, N], "active": bool[E, N]}``.

    ``lane`` holds ``node_mb``, ``small_frac``, ``unified`` (per node),
    ``replacement``, ``routing``, ``cloud_rtt_s``, ``cloud_cold_prob``,
    ``max_slots`` and ``autoscale`` (``None`` or a dict of
    ``epoch_events``, ``min_frac``, ``max_frac``, ``gain``); ``trace``
    the six columns ``t``, ``func_id``, ``size_mb``, ``cls``,
    ``warm_dur``, ``cold_dur``."""
    n = len(lane["node_mb"])
    unified = np.asarray(lane["unified"], bool)
    caps = pool_caps(lane["node_mb"], lane["small_frac"], unified)
    uids = new_uids()
    pools = [[Pool(caps[j, k], lane["replacement"], lane["max_slots"],
                   uids, rnd) for k in (0, 1)] for j in range(n)]
    route = ROUTING[lane["routing"]]
    reads_free = lane["routing"] in _READS_FREE
    rtt, ccp = F(lane["cloud_rtt_s"]), F(lane["cloud_cold_prob"])
    t, fid, size, cls, warm, cold = (trace[k] for k in (
        "t", "func_id", "size_mb", "cls", "warm_dur", "cold_dur"))
    h1, h2 = route_hashes(fid, n)
    up = np.ones(n, bool)
    idx = np.arange(n)
    tgt = [np.where(unified, 0, c) for c in (0, 1)]
    cap32 = caps.astype(np.float32)
    cap_by = [cap32[idx, g] for g in tgt]
    asc = lane.get("autoscale")
    if asc is not None:
        epoch = int(asc["epoch_events"])
        mn, mx, gain = F(asc["min_frac"]), F(asc["max_frac"]), F(asc["gain"])
        frac = np.asarray(lane["small_frac"], np.float32)
        node_mb = np.asarray(lane["node_mb"], np.float32)
        press = np.zeros((n, 2), np.float32)
        fracs, actives = [], []
    T = len(t)
    node_out = np.empty(T, np.int32)
    out_out = np.empty(T, np.int32)
    for i in range(T):
        c = int(cls[i])
        g = tgt[c]
        free = (np.fromiter((pools[j][g[j]].free_mb for j in range(n)),
                            np.float32, n) if reads_free else None)
        node = 0
        if n > 1:
            ev = {"h1": int(h1[i]), "h2": int(h2[i]), "size": F(size[i]),
                  "warm": F(warm[i]), "cold": F(cold[i])}
            node = route(ev, free, cap_by[c], up, rtt, ccp)
        out = pools[node][int(g[node])].access(
            float(t[i]), int(fid[i]), float(size[i]), float(warm[i]),
            float(cold[i]))
        node_out[i], out_out[i] = node, out
        if asc is None:
            continue
        if out == MISS:
            press[node, c] += 1.0
        elif out == DROP:
            press[node, c] += 2.0
        if (i + 1) % epoch:
            continue
        ps, pl = press[:, 0], press[:, 1]
        tot = ps + pl
        delta = np.where(tot > 0, gain * (ps - pl)
                         / np.where(tot > 0, tot, F(1.0)), F(0.0))
        cand = np.minimum(mx, np.maximum(frac + delta, mn))
        frac = np.where(unified, frac, cand).astype(np.float32)
        cap_s, cap_l = node_mb * frac, node_mb * (F(1.0) - frac)
        for j in range(n):
            if unified[j]:
                continue
            pools[j][0].resize(float(t[i]), float(cap_s[j]))
            pools[j][1].resize(float(t[i]), float(cap_l[j]))
            cap32[j, 0], cap32[j, 1] = cap_s[j], cap_l[j]
        cap_by = [cap32[idx, g2] for g2 in tgt]
        press[:] = 0.0
        fracs.append(frac.copy())
        actives.append(np.ones(n, bool))
    res = {"node": node_out, "outcome": out_out}
    if asc is not None:
        if T % epoch:
            fracs.append(frac.copy())
            actives.append(np.ones(n, bool))
        res["fracs"] = (np.stack(fracs) if fracs
                        else np.zeros((0, n), np.float32))
        res["active"] = (np.stack(actives) if actives
                         else np.zeros((0, n), bool))
    return res
