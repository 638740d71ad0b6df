"""The benchmark of ``repro_torch``: one cell, one seed, one run.

A cell names a configuration (``configs/<name>.json``: the deployment)
and a traffic mix (``traffic/<name>.json``: the trace, the grid of
lanes and the step mode).  A job is one
``repro_torch.sim.sweep(trace, scenarios, mode=...)`` call over the
cell's whole trace and grid: one group, the lanes a tensor axis.  The
window runs jobs back to back, one client in a closed loop, for
``--seconds`` (the job running when they expire is finished and
counted).  Set-up builds the trace and the grid from ``--seed`` and runs
the same lanes and mode over a short head of the trace, which builds B1
and captures the same cached block runner; the window then captures
nothing.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read by the readers in ``metrics/<name>.py`` from the
profiled job: the first that starts in the second half of the window.
Both check every job's sampled lanes against the plain reference
(``reference/``) once the window has closed.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from . import compare, generate

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: Top-level module names a run may never hold: the JAX package and
#: JAX itself (compared whole: ``repro_torch`` is not ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, per_layer: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones, or its per-layer
    ones; a metric with a ``workloads`` key only in the cells it names."""
    return [m for m in bench["per_layer" if per_layer else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


#: Events of the trace's head that set-up runs through the cell's lanes,
#: and lanes a job checks against the reference; a mix may set either
#: (``warmup_events``, ``check_lanes``).
WARMUP_EVENTS = 1024
CHECK_LANES = 48
#: Device types on which ``fused`` mode decides with B1's kernel (the
#: CPU runs its plain version, which counts no launches).
B1_DEVICES = ("cuda",)


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a cell's first run there builds."""
    base = REPO / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def _program():
    src = str(REPO / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.sim as sim
    from repro_torch.cluster import graphs
    from repro_torch.core.types import Trace
    from repro_torch.kernels import pool_step
    return sim, graphs, Trace, pool_step


def scenario(sim, lane: dict):
    asc = lane["autoscale"]
    return sim.Scenario(
        node_mb=tuple(lane["node_mb"]), small_frac=tuple(lane["small_frac"]),
        unified=tuple(lane["unified"]), replacement=lane["replacement"],
        routing=lane["routing"], cloud_rtt_s=lane["cloud_rtt_s"],
        cloud_cold_prob=lane["cloud_cold_prob"],
        max_slots=lane["max_slots"],
        autoscale=None if asc is None else sim.Autoscale(**asc))


def answer(res) -> dict:
    """What the comparison reads of one lane's ``Result``."""
    return {"node": res.node, "outcome": res.outcome,
            "latencies": res.latencies, "per_node": res.per_node,
            "summary": res.summary(), "fracs": res.fracs,
            "active": res.active}


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(config: dict, mix: dict, seed: int, seconds: float,
             traced: bool, device: str, metrics: list[dict],
             t0: float, log=print) -> dict:
    """One run of the cell made of ``config`` and ``mix``; returns the
    result line's object.  ``t0`` is the process's start on the
    ``perf_counter`` clock.  ``device`` is ``"cuda"``, or ``"cpu"`` for
    the harness's tests (no peaks, no trace, no B1 launches there)."""
    import torch
    sim, graphs, Trace, pool_step = _program()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    trace_np = generate.edge_trace(seed, mix["trace"])
    grid = generate.lanes(config, mix)
    sample = generate.check_sample(
        grid, mix.get("check_lanes", CHECK_LANES), seed)
    scns = [scenario(sim, lane) for lane in grid]
    mode = mix["mode"]
    n_events = len(trace_np["t"])

    def to_trace(tr):
        return Trace(*(tr[k] for k in ("t", "func_id", "size_mb", "cls",
                                       "warm_dur", "cold_dur")))
    trace = to_trace(trace_np)

    def job():
        res = sim.sweep(trace, scns, mode=mode, rng_seed=seed, device=dev)
        _sync(torch, dev)
        return {g: res[g] for g in sample}, res

    warmup = generate.head(trace_np, mix.get("warmup_events", WARMUP_EVENTS))
    sim.sweep(to_trace(warmup), scns, mode=mode, rng_seed=seed, device=dev)
    _sync(torch, dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    captures0 = graphs.STATS["captures"]
    b1_0 = pool_step.evict_place_cuda.launches
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: {len(grid)} lanes x {n_events} events, "
        f"mode {mode}, {len(sample)} lanes checked")

    profs, jobs, walls = [], [], []
    w0 = time.perf_counter()
    while True:
        got = None      # one job's results alive at a time
        j0 = time.perf_counter()
        if traced and not profs and j0 - w0 >= seconds / 2:
            prof, got = _profiled(torch, job, graphs, pool_step)
            profs.append(prof)
        else:
            got = job()
        jobs.append(got[0])
        walls.append(time.perf_counter() - j0)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    window_jobs = len(jobs)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    captures = graphs.STATS["captures"] - captures0
    b1 = pool_step.evict_place_cuda.launches - b1_0
    for i, w in enumerate(walls):
        log(f"job {i}: {w:.3f} s, {len(grid) * n_events / w:.1f} "
            "lane-events/s")

    digests = []
    if traced:
        digests = _read_traces(profs, torch, job, graphs, pool_step, mode,
                               n_events, jobs, log)
    profs.clear()
    last_full = got[1]
    outcome_counts = np.bincount(
        np.concatenate([r.outcome for r in last_full]), minlength=3)
    del got, last_full
    run = {"lanes": len(grid), "events": n_events, "jobs": window_jobs,
           "window_s": window_s, "setup_s": setup_s, "peak_bytes": peak,
           "nodes": len(grid[0]["node_mb"]),
           "slots": config["max_slots"], "digests": digests,
           "hits": int(outcome_counts[0]), "misses": int(outcome_counts[1])}
    values = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    t_ref = time.perf_counter()
    from .reference import lane_answer
    want = {g: lane_answer(grid[g], trace_np, seed) for g in sample}
    got_answers = [{g: answer(r) for g, r in job_.items()} for job_ in jobs]
    cmp = compare.compare(got_answers, want)
    log(f"reference: {len(sample)} lanes in "
        f"{time.perf_counter() - t_ref:.2f} s")
    checks = {k: {"value": cmp[k], "limit": lim}
              for k, lim in compare.LIMITS.items()}
    checks["captures_in_window"] = {"value": captures, "limit": 0}
    if dev.type in B1_DEVICES:
        # the window's jobs only: ``b1`` was read as it closed
        want_b1 = n_events * window_jobs if mode == "fused" else 0
        checks["b1_launch_gap"] = {"value": abs(b1 - want_b1), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": max(peak, setup_peak)}
    out = {"correct": correct, "attempted": len(jobs),
           "failed": cmp["jobs_failed"], "metrics": values,
           "device": device_info}
    if digests:
        d = digests[0]
        device_info.update(busy_s=d["busy_s"], window_s=d["span_s"])
        out["breakdown"] = d["breakdown"]
    out["checks"] = checks
    return out


def _profiled(torch, job, graphs, pool_step):
    """One job under the profiler, inside the harness's job span; the
    runner's counters of that job ride along for the cross-check."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from .trace_reader import JOB_SPAN
    blocks0 = graphs.STATS["blocks"]
    b1_0 = pool_step.evict_place_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(JOB_SPAN):
            got = job()
    prof.portbench_counts = {
        "blocks": graphs.STATS["blocks"] - blocks0,
        "b1": pool_step.evict_place_cuda.launches - b1_0}
    return prof, got


#: Profiled jobs tried before the trace is given up: the profiler has
#: been seen to lose records.
TRACE_ATTEMPTS = 2


def _read_traces(profs, torch, job, graphs, pool_step, mode, n_events,
                 jobs, log) -> list[dict]:
    """The digest of the first profiled job whose records agree with the
    runner's own counts (every graph replay's launch seen on the host,
    and in ``fused`` every B1 launch seen on the device).  Where the
    window profiled no job, or one whose records do not agree, another
    job is profiled after the window, up to :data:`TRACE_ATTEMPTS` in
    all; those jobs are checked against the reference too."""
    from . import trace_reader
    for attempt in range(TRACE_ATTEMPTS):
        if attempt >= len(profs):
            prof, got = _profiled(torch, job, graphs, pool_step)
            profs.append(prof)
            jobs.append(got[0])
        prof = profs[attempt]
        t = time.perf_counter()
        d = trace_reader.digest(prof)
        counts = prof.portbench_counts
        ok = d is not None and d["graph_launches"] == counts["blocks"] and (
            mode != "fused" or d["b1_records"] == counts["b1"] == n_events)
        log(f"trace {attempt}: read in {time.perf_counter() - t:.2f} s; "
            + ("no job span or device record" if d is None else
               f"{d['records']} device records, {d['graph_launches']} "
               f"graph launches (runner: {counts['blocks']}), "
               f"{d['b1_records']} B1 records (launches: {counts['b1']})")
            + ("" if ok else "; records lost, profiling another job"))
        if ok:
            d.update(events=n_events)
            return [d]
    return []


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    set_caches()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    config = generate.load_json("configs", cell["config"])
    mix = generate.load_json("traffic", cell["traffic"])

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    out = run_cell(config, mix, args.seed, args.seconds, bool(args.trace),
                   "cuda", cell_metrics(bench, args.workload,
                                        bool(args.trace)), t0, log)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
