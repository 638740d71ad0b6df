#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Needs one CUDA card and ``nvcc``; exits non-zero without them, and when
run outside a checkout.  Imports no JAX and nothing of ``repro``.
Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the kernel from ``src/repro_torch/kernels/csrc`` (timed);
3. kernels: each kernel against its plain torch version on tie-heavy
   quantized batches at the main path's shapes and a ragged one, bitwise
   on every output, then timed per launch with CUDA events;
4. the main path: the README quickstart's trace, ``edge_trace(seed=0,
   duration_s=3600)`` (11,215 invocations, 140 functions; stored as
   ``repro_torch.workloads.quickstart_trace``), through
   ``Scenario.kiss(4096.0)`` (2 pools x 1024 slots) and the 16-node
   ``het16_cluster("size_aware")`` (32 pools x 256 slots) in every step
   mode on the card, under
   ``torch.cuda.set_sync_debug_mode("error")`` (no per-event host sync),
   with the launch counts zeroed just before and read just after; every
   mode must give the same per-event ``(node, outcome)`` and match the
   digests of the JAX reference (``GOLDEN``, pinned by
   ``tests/test_torch_sim.py``); a CPU ``gather`` run must match them too;
5. the device's busy share over a profiled stretch of the path;
6. one JSON line of kernel measurements, then ``{"ok": true, ...}``.

Tolerance everywhere is bitwise.  Any mismatch or fault exits non-zero.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: The JAX reference's per-event results on the quickstart trace
#: (blake2s of the int32 bytes of ``node``/``outcome``; outcome counts
#: hit/miss/drop) and the trace's fingerprint.
GOLDEN_TRACE = "5489dd9ada1ec219cdf06755e781cf07e50c73ebc93a9b57c823baf3b67c8a79"
GOLDEN = {
    "kiss4096": dict(
        node="38e86a450f4b173d799627da98a5cb91d1f0ec4859c179c575f209f1c4b8f94b",
        outcome="f505a59d7e0ff83363854ecfddaac3cfb578e3b5147c53f1dbb60ebd1589cbbd",
        counts=[6783, 2988, 1444]),
    "het16_size_aware": dict(
        node="5343eaef53911129c43daf12ec35c7272bf9863fe038ddd8286687984cb0f49f",
        outcome="9f0f67d28a2c7524544c18be9b92b718f71b3e7ec8900d763eb29b1057b19016",
        counts=[10920, 222, 73]),
}

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core op/s.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12

KERNEL_SHAPES = ((2, 1024), (32, 256), (3, 1000))   # path, path, ragged


class SmokeError(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def digest(a) -> str:
    return hashlib.blake2s(
        np.ascontiguousarray(a, np.int32).tobytes()).hexdigest()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi reported no card")
    return out[0].strip()


def tie_batch(rng, p: int, s: int):
    """Quantized tie-heavy evict-and-place inputs (priorities in {0..3},
    distinct seqs, whole-MB sizes); row 0 is all busy, row 1 (if any)
    has a deficit <= 0."""
    pri = rng.integers(0, 4, (p, s)).astype(np.float32)
    seq = rng.permutation(np.arange(1.0, p * s + 1, dtype=np.float32)
                          ).reshape(p, s)
    size = rng.integers(1, 400, (p, s)).astype(np.float32)
    valid = rng.random((p, s)) < 0.9
    idle = valid & (rng.random((p, s)) < 0.7)
    idle[0] = False
    pri = np.where(idle, pri, np.inf).astype(np.float32)
    deficit = rng.integers(0, 40 * s, (p,)).astype(np.float32)
    if p > 1:
        deficit[1] = -float(rng.integers(0, 40))
    return pri, seq, size, idle, valid, deficit


def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters``
    calls queued behind a ~50 ms spin kernel, so the host's launch cost
    (the Python wrapper, ~tens of us a call) stays off the clock."""
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int) -> float:
    """Mean milliseconds per call back to back, host cost included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def evict_place_bound_ms(p: int, s: int) -> tuple[float, str]:
    """Least time for one evict-and-place at [p, s] on an H100, the
    larger of: the bytes (pri/seq/size f32 and idle/valid 1 B in, evict
    1 B out, per slot; deficit in and freed/ins/avail/empty out, per
    row) over HBM; and the f32 operations the function needs, whatever
    method computes it, over the f32 peak.  The function is a sort of
    each row's slots by (pri, seq) (s * ceil(log2 s) compares of two
    operations each), a prefix sum and its compare with the deficit,
    the freed and available sums and the first-empty search (one
    operation a slot each).  The kernel's own all-pairs count does
    4 * p * s * s operations instead, which the bound does not charge."""
    nbytes = p * s * (4 + 4 + 4 + 1 + 1 + 1) + p * (4 + 4 + 4 + 4 + 1)
    ops = p * (2 * s * max(1, (s - 1).bit_length()) + 5 * s)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev) -> dict:
    from repro_torch.kernels.pool_step import (evict_place_cuda,
                                               evict_place_plain)
    rows = []
    for p, s in KERNEL_SHAPES:
        args = tuple(torch.tensor(a, device=dev) for a in
                     tie_batch(np.random.default_rng(p * s), p, s))
        got = evict_place_cuda(*args)
        want = evict_place_plain(*args)
        torch.cuda.synchronize()
        err = 0.0
        for name, g, w in zip(("evict", "freed", "ins", "avail", "empty"),
                              got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"evict_place [{p},{s}] {name}: dtype/shape differ")
            check(torch.equal(g, w),
                  f"evict_place [{p},{s}] {name}: kernel != plain")
            err = max(err, float((g.double() - w.double()).abs().max()))
        ms = device_ms(lambda: evict_place_cuda(*args), 100)
        call = call_ms(lambda: evict_place_cuda(*args), 300)
        plain_ms = device_ms(lambda: evict_place_plain(*args), 20)
        bound_ms, bound_by = evict_place_bound_ms(p, s)
        rows.append(dict(shape=[p, s], max_abs_err=err, ms=ms,
                         call_ms=call, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"kernel pool_step.evict_place [{p},{s}]: bitwise == plain; "
              f"device {ms * 1e3:.2f} us/launch ({call * 1e3:.2f} us a "
              f"call back to back), plain {plain_ms * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.4f} us ({bound_by})", flush=True)
    return {"rows": rows}


def scenarios():
    from repro_torch.cluster.presets import het16_cluster
    from repro_torch.sim import Scenario
    return {"kiss4096": Scenario.kiss(4096.0),
            "het16_size_aware": Scenario.from_cluster(
                het16_cluster("size_aware"))}


def check_result(name: str, run: str, res, n_events: int) -> dict:
    """Check the ``run`` of scenario ``name``: shapes, ranges, a finite
    summary, and the JAX reference's digests.  Returns the summary."""
    what = f"{name}/{run}"
    node, outcome = res.node, res.outcome
    n_nodes = res.scenario.n_nodes
    check(node.shape == outcome.shape == (n_events,), f"{what}: shape")
    check(((node >= 0) & (node < n_nodes)).all(), f"{what}: node range")
    check(np.isin(outcome, (0, 1, 2)).all(), f"{what}: outcome codes")
    summary = res.summary()
    check(all(np.isfinite(v) for v in summary.values()),
          f"{what}: non-finite summary value")
    got = dict(node=digest(node), outcome=digest(outcome),
               counts=np.bincount(outcome, minlength=3).tolist())
    check(got == GOLDEN[name],
          f"{what}: {got} != the JAX reference {GOLDEN[name]}")
    return summary


def sync_guard_refuses(dev) -> bool:
    """Positive control for ``set_sync_debug_mode("error")``: a host read
    of a device value must raise."""
    try:
        torch.zeros(1, device=dev).item()
    except RuntimeError:
        return True
    return False


def path_phase(dev, trace) -> dict:
    from repro_torch.kernels.pool_step import evict_place_cuda
    from repro_torch.sim import simulate
    from repro_torch.sim.api import trace_fingerprint

    check(trace_fingerprint(trace) == GOLDEN_TRACE,
          "the stored trace differs from the one the reference ran")
    n = len(trace)
    modes = ("gather", "vmap", "fused")
    summaries, rates = {}, {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        check(sync_guard_refuses(dev),
              "sync debug mode did not refuse a host sync")
        evict_place_cuda.launches = 0       # the main path starts here
        for name, scn in scenarios().items():
            for mode in modes:
                t0 = time.perf_counter()
                res = simulate(scn, trace, mode=mode, device=dev)
                dt = time.perf_counter() - t0
                summaries[name, mode] = check_result(name, mode, res, n)
                rates[name, mode] = n / dt
                print(f"path {name} mode={mode} on {dev}: {n} events in "
                      f"{dt:.2f} s = {n / dt:.1f} events/s; matches the "
                      f"JAX reference bitwise", flush=True)
        launches = evict_place_cuda.launches  # ... and ends here
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(launches == 2 * n,
          f"fused runs launched the kernel {launches} times, want {2 * n}")
    for name, scn in scenarios().items():
        t0 = time.perf_counter()
        res = simulate(scn, trace, mode="gather", device="cpu")
        dt = time.perf_counter() - t0
        summary = check_result(name, "cpu", res, n)
        for mode in modes:
            check(summaries[name, mode] == summary,
                  f"{name}/{mode}: summary differs from the CPU run")
        print(f"path {name} mode=gather on cpu: {n / dt:.1f} events/s; "
              f"equal to the card's runs", flush=True)
    return {"launches": launches, "rates": rates}


def busy_phase(dev, trace, n_events: int = 200) -> dict:
    """Device busy share over the first ``n_events`` of the kiss
    scenario in each mode: summed device time of every kernel and copy
    the profiler saw, over the host wall time of the run.  The window is
    short because the profiler's post-processing costs ~0.1 s an event."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim import simulate
    head, scn = trace.head(n_events), scenarios()["kiss4096"]
    out = {}
    for mode in ("gather", "fused"):
        simulate(scn, head.head(50), mode=mode, device=dev)   # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            simulate(scn, head, mode=mode, device=dev)
            wall = time.perf_counter() - t0
        def dev_us(e):
            return getattr(e, "self_device_time_total", 0.0)
        events = prof.key_averages()
        top = sorted(events, key=dev_us, reverse=True)[:3]
        out[mode] = sum(dev_us(e) for e in events) / 1e6 / wall
        print(f"busy {mode}: device busy {100 * out[mode]:.1f}% of "
              f"{wall:.2f} s wall over {n_events} events; top device "
              "time: " + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.1f} ms"
                                   for e in top), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    _build.build.cache_clear()
    lib, log, build_s = _build.build("pool_step")
    print(f"build pool_step: {lib.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build_s:.2f} s)")
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    kernels = kernel_phase(dev)
    from repro_torch.workloads import quickstart_trace
    trace = quickstart_trace()
    path = path_phase(dev, trace)
    busy = busy_phase(dev, trace)

    main_row = kernels["rows"][0]            # [2, 1024]: Scenario.kiss
    entry = dict(name="pool_step.evict_place", route="cuda",
                 source="src/repro_torch/kernels/csrc/pool_step.cu",
                 replaces="src/repro/kernels/pool_step.py:41",
                 launches=path["launches"],
                 # each wrapper launch runs these two __global__ kernels
                 cuda_kernels=["rank_kernel", "reduce_kernel"],
                 cuda_kernel_launches=2 * path["launches"],
                 max_abs_err=max(r["max_abs_err"] for r in kernels["rows"]),
                 ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                 bound_ms=main_row["bound_ms"],
                 bound_by=main_row["bound_by"], library_ms=None,
                 shape=main_row["shape"], per_shape=kernels["rows"])
    print('kernels: ["pool_step.evict_place"]')
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"events_per_s": {
        f"{k[0]}/{k[1]}": v for k, v in path["rates"].items()},
        "device_busy_share": busy, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
