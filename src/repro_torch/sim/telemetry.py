"""Telemetry: windowed time series, event timelines, run manifests
(port of ``repro.sim.telemetry``).

``Scenario(..., telemetry=Telemetry(window_events=N))`` makes a run
keep, per window of ``N`` events: per-class hit/miss(cold)/drop counts,
per-node free MB and resident containers after the window's last event,
the residents invalidated (failure recovery and retirement), the up and
active node counts, and the chain deadline misses.  The windows equal
the reference's bitwise (``tests/test_torch_telemetry.py``); window
indices are global event indices, so any ``chunk_events`` gives the
monolithic windows, and the counters sum exactly to the run's
``summary()`` totals.  How the engine gathers them is in
``repro_torch.cluster.engine`` (``TelSink``, ``_tel_np``).

On top of the windows, :func:`trace_events` exports a Chrome/Perfetto
trace-event JSON (counter tracks for the window series, duration tracks
for node outages, instants for autoscaler spawns/retires and
re-splits), and :func:`run_manifest` records the identity of a run
(scenario hash, trace fingerprint, engine, mode, chunking, device and
the torch, CUDA, numpy and Python versions).  The module is numpy and
the standard library, as the reference's is; :func:`versions` reads
torch's version strings, never JAX's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import sys

import numpy as np

#: Manifest schema identifiers (the reference's: a manifest of either
#: package has the same shape).
RUN_MANIFEST_SCHEMA = "repro.sim/run-manifest@1"
BENCH_MANIFEST_SCHEMA = "repro.sim/bench-manifest@1"


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """The telemetry knob on :class:`repro_torch.sim.Scenario`.

    ``window_events`` is the window length in *events* (not seconds), so
    the series is exact: every invocation lands in exactly one window.
    Frozen and hashable, like every other scenario knob.
    """

    window_events: int = 1024

    def __post_init__(self):
        w = self.window_events
        try:
            ok = int(w) == w and w >= 1
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise ValueError(
                f"window_events must be a positive integer, got {w!r}")
        object.__setattr__(self, "window_events", int(w))

    def n_windows(self, n_events: int) -> int:
        """Windows covering ``n_events`` (the last one may be partial)."""
        return -(-int(n_events) // self.window_events)


@dataclasses.dataclass(frozen=True)
class TelemetrySeries:
    """The stacked window arrays one telemetry-enabled run produces.

    ``W`` = number of windows, ``N`` = nodes.  Counter arrays are exact
    integers; snapshot arrays are the state *after the last event of the
    window* (windows always contain at least one event by construction).
    """

    #: window length in events (the knob that produced this series)
    window_events: int
    #: i64[W, 2, 3] invocations per (window, size class, outcome) with
    #: outcome columns (hit, miss/cold, drop) — sums exactly to the
    #: run's ``summary()`` totals
    counts: np.ndarray
    #: f32[W, N] free MB per node at window end (f32-mirrored: bit-equal
    #: across engines; negative while busy containers overhang a shrink)
    free_mb: np.ndarray
    #: i64[W, N] resident containers per node at window end
    occupancy: np.ndarray
    #: i64[W] residents invalidated during the window (failure recovery
    #: + autoscaler retirement) — sums to ``Result.n_invalidated``
    invalidated: np.ndarray
    #: i64[W] failure-up node count at window end (N without a schedule)
    nodes_up: np.ndarray
    #: i64[W] autoscaler-active node count at window end (N when node
    #: scaling is off)
    nodes_active: np.ndarray
    #: i64[W] chain deadline misses judged during the window (a chain is
    #: judged exactly once, at its final stage) — sums to the run's
    #: missed-chain count; all zeros when chains are off
    chain_miss: np.ndarray
    #: f32[W] event time of the first / last event in each window
    t_start: np.ndarray
    t_end: np.ndarray
    #: i64[W] global index of the first event in each window
    event_start: np.ndarray

    def __len__(self) -> int:
        return int(self.counts.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.free_mb.shape[1])

    # -- derived series (per window, summed over classes) ------------------
    @property
    def hits(self) -> np.ndarray:
        return self.counts[:, :, 0].sum(axis=1)

    @property
    def misses(self) -> np.ndarray:
        """Cold starts per window (the paper's headline signal)."""
        return self.counts[:, :, 1].sum(axis=1)

    @property
    def drops(self) -> np.ndarray:
        return self.counts[:, :, 2].sum(axis=1)

    @property
    def offloads(self) -> np.ndarray:
        """Cloud offloads per window — every drop is priced as one."""
        return self.drops

    @property
    def events(self) -> np.ndarray:
        """Invocations per window (== window_events except the last)."""
        return self.counts.sum(axis=(1, 2))

    def cold_start_pct(self) -> np.ndarray:
        """f64[W] per-window cold-start percentage (the Fig 5-style
        trajectory the end-of-run scalar hides)."""
        n = np.maximum(self.events, 1)
        return 100.0 * self.misses / n

    def drop_pct(self) -> np.ndarray:
        n = np.maximum(self.events, 1)
        return 100.0 * self.drops / n

    def table(self) -> list[dict]:
        """One plain-dict row per window — the quick-look view."""
        return [{"window": int(w),
                 "t_start": float(self.t_start[w]),
                 "t_end": float(self.t_end[w]),
                 "events": int(self.events[w]),
                 "hits": int(self.hits[w]),
                 "misses": int(self.misses[w]),
                 "drops": int(self.drops[w]),
                 "invalidated": int(self.invalidated[w]),
                 "nodes_up": int(self.nodes_up[w]),
                 "nodes_active": int(self.nodes_active[w]),
                 "chain_miss": int(self.chain_miss[w])}
                for w in range(len(self))]


def series_from_arrays(arrays: dict, trace, window_events: int
                       ) -> TelemetrySeries:
    """Assemble the :class:`TelemetrySeries` from the engine-level window
    arrays (already junk-row-free) plus the host-side time axis."""
    w = int(arrays["counts"].shape[0])
    n_events = len(trace)
    starts = np.arange(w, dtype=np.int64) * int(window_events)
    ends = np.minimum(starts + int(window_events), n_events) - 1
    t = np.asarray(trace.t, np.float32)
    return TelemetrySeries(
        window_events=int(window_events),
        counts=np.asarray(arrays["counts"], np.int64),
        free_mb=np.asarray(arrays["free_mb"], np.float32),
        occupancy=np.asarray(arrays["occupancy"], np.int64),
        invalidated=np.asarray(arrays["invalidated"], np.int64),
        nodes_up=np.asarray(arrays["nodes_up"], np.int64),
        nodes_active=np.asarray(arrays["nodes_active"], np.int64),
        chain_miss=np.asarray(
            arrays.get("chain_miss", np.zeros(w, np.int64)), np.int64),
        t_start=t[starts] if w else np.zeros(0, np.float32),
        t_end=t[ends] if w else np.zeros(0, np.float32),
        event_start=starts)


# --------------------------------------------------------------------------
# Chrome / Perfetto trace-event export
# --------------------------------------------------------------------------
# The JSON shape follows the Trace Event Format (the `chrome://tracing`
# and Perfetto "legacy JSON" input): a flat `traceEvents` list of dicts
# keyed by `ph` (phase) — "M" metadata, "C" counter, "X" complete
# (duration), "i" instant.  Timestamps are microseconds of *simulated*
# time.  The schema below is pinned by tests/test_telemetry.py.

_PID_CLUSTER = 0     # counter tracks (window series)
_PID_NODES = 1       # per-node tracks (outages, spawns/retires, splits)


def _meta(pid: int, name: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": name}}


def _counter(name: str, ts_us: float, args: dict) -> dict:
    return {"ph": "C", "pid": _PID_CLUSTER, "tid": 0, "name": name,
            "ts": ts_us, "args": args}


def trace_events(result, path: str | None = None) -> dict:
    """Export one :class:`repro_torch.sim.Result` as a trace-event JSON
    dict (the reference's schema, ``repro.sim/trace-events@1``).

    Tracks (whatever the run recorded — no telemetry means no counter
    series, a static run means no outage/autoscale tracks):

    * counter tracks per window: outcomes (hits/misses/drops), cloud
      offloads, invalidations, per-node free MB and occupancy, up/active
      node counts;
    * one duration event per ``Failures`` outage window (pid 1, tid =
      node);
    * instant events for autoscaler node spawns/retires and per-node
      split re-sizings at their epoch boundary.

    ``path`` writes the JSON too.  Load it in ``chrome://tracing`` or
    https://ui.perfetto.dev — simulated seconds appear as microseconds.
    """
    scn = result.scenario
    events: list[dict] = [_meta(_PID_CLUSTER, "cluster windows"),
                          _meta(_PID_NODES, "nodes")]
    us = 1e6

    tel = result.telemetry
    if tel is not None:
        for w in range(len(tel)):
            ts = float(tel.t_start[w]) * us
            events.append(_counter("outcomes", ts, {
                "hits": int(tel.hits[w]), "misses": int(tel.misses[w]),
                "drops": int(tel.drops[w])}))
            events.append(_counter("cloud_offloads", ts,
                                   {"offloads": int(tel.offloads[w])}))
            events.append(_counter("invalidated", ts,
                                   {"invalidated": int(tel.invalidated[w])}))
            events.append(_counter("nodes", ts, {
                "up": int(tel.nodes_up[w]),
                "active": int(tel.nodes_active[w])}))
            events.append(_counter("free_mb", ts, {
                f"node{j}": float(tel.free_mb[w, j])
                for j in range(tel.n_nodes)}))
            events.append(_counter("occupancy", ts, {
                f"node{j}": int(tel.occupancy[w, j])
                for j in range(tel.n_nodes)}))
            # chains off ⇒ no track (the counter set of chainless runs
            # is pinned by tests/test_telemetry.py)
            if scn.chains is not None:
                events.append(_counter(
                    "chain_misses", ts,
                    {"missed": int(tel.chain_miss[w])}))

    if scn.failures is not None:
        for t_down, t_up, node in scn.failures.windows:
            events.append({"ph": "X", "pid": _PID_NODES, "tid": int(node),
                           "name": f"outage node{node}", "cat": "failure",
                           "ts": float(t_down) * us,
                           "dur": float(t_up - t_down) * us, "args": {}})

    # autoscaler timeline: membership flips + split moves per epoch, at
    # the epoch's boundary time (epoch_t is attached by simulate/sweep)
    ep_t = getattr(result, "epoch_t", None)
    if scn.autoscale is not None and ep_t is not None and len(ep_t):
        active = result.active
        fracs = result.fracs
        init = np.ones(scn.n_nodes, bool)
        k = scn.autoscale.init_active
        if k is not None:
            init[k:] = False
        prev_a, prev_f = init, np.asarray(scn.small_frac, np.float32)
        for e in range(active.shape[0]):
            ts = float(ep_t[e]) * us
            for j in range(scn.n_nodes):
                if active[e, j] != prev_a[j]:
                    kind = "spawn" if active[e, j] else "retire"
                    events.append({"ph": "i", "pid": _PID_NODES,
                                   "tid": j, "s": "p", "cat": "autoscale",
                                   "name": f"{kind} node{j}", "ts": ts,
                                   "args": {"epoch": e}})
                if fracs[e, j] != prev_f[j]:
                    events.append({"ph": "i", "pid": _PID_NODES,
                                   "tid": j, "s": "p", "cat": "autoscale",
                                   "name": f"resplit node{j}", "ts": ts,
                                   "args": {"epoch": e,
                                            "small_frac": float(fracs[e, j])}})
            prev_a, prev_f = active[e], fracs[e]

    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"scenario": scn.label,
                         "schema": "repro.sim/trace-events@1"}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


# --------------------------------------------------------------------------
# run manifests
# --------------------------------------------------------------------------

def trace_fingerprint(trace) -> str:
    """Deterministic identity of a trace: blake2s over every array's
    bytes + dtype + shape, as the reference computes it, so both packages
    fingerprint a trace alike."""
    h = hashlib.blake2s()
    for name, arr in zip(trace._fields, trace):
        if arr is None:
            # optional fields (chain metadata on chainless traces):
            # skipping them keeps chainless fingerprints identical to
            # the pre-chain era, so pinned baselines stay valid
            continue
        a = np.ascontiguousarray(arr)
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def scenario_hash(scenario) -> str:
    """Process-stable scenario identity (``hash()`` is salted per
    process): blake2s of the canonical frozen-dataclass repr."""
    return hashlib.blake2s(repr(scenario).encode()).hexdigest()[:16]


def versions() -> dict:
    """The software a run's numbers came from: the port records torch
    and the CUDA it was built for (``None`` for a CPU-only build) where
    the reference records JAX."""
    import torch
    return {"python": sys.version.split()[0],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "numpy": np.__version__,
            "platform": platform.platform()}


def run_manifest(result) -> dict:
    """The structured identity of one finished run — everything needed to
    reproduce or audit it.  ``Result.manifest()`` delegates here."""
    scn = result.scenario
    info = dict(result.run_info or {})
    asc = scn.autoscale
    tel = scn.telemetry
    ch = scn.chains
    return {
        "schema": RUN_MANIFEST_SCHEMA,
        "scenario": {
            "label": scn.label,
            "hash": scenario_hash(scn),
            "n_nodes": scn.n_nodes,
            "node_mb": list(scn.node_mb),
            "small_frac": list(scn.small_frac),
            "unified": list(scn.unified),
            "routing": scn.routing,
            "replacement": scn.replacement,
            "max_slots": scn.max_slots,
            "cloud_rtt_s": scn.cloud_rtt_s,
            "cloud_cold_prob": scn.cloud_cold_prob,
            "autoscale": dataclasses.asdict(asc) if asc else None,
            "failures": ([list(w) for w in scn.failures.windows]
                         if scn.failures else None),
            "telemetry_window_events": tel.window_events if tel else None,
            "chains": dataclasses.asdict(ch) if ch else None,
        },
        "trace": {"fingerprint": info.pop("trace_fingerprint", None),
                  "n_events": len(result)},
        "run": info,
        "versions": versions(),
        "summary": result.summary(),
    }


def write_manifest(manifest: dict, path: str) -> str:
    """Write a manifest dict as pretty JSON; returns ``path``."""
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True, default=float)
    return path
