"""From one profiled job to the numbers the per-layer readers take.

The profiler's raw records are read directly (no per-record Python
event objects are built), so a job of some million device records is
read in seconds.  Device records are the card's kernels, copies and
sets; host records are the operators and runtime calls on the host and
the harness's own spans.
"""
from __future__ import annotations

import numpy as np

#: The harness's span around one job.
JOB_SPAN = "portbench.job"
#: Entries kept in each list of the breakdown.
TOP = 10


def _records(prof):
    from torch.autograd import DeviceType
    dev_s, dev_e, names = [], [], {}
    b1_n, b1_ns = 0, 0
    host = []
    span = None
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if name == JOB_SPAN or ev.is_user_annotation():
                continue        # the span's mirror on the device timeline
            dev_s.append(start)
            dev_e.append(start + dur)
            names[name[:64]] = names.get(name[:64], 0) + dur
            if "evict_place_kernel" in name:
                b1_n += 1
                b1_ns += dur
        elif name == JOB_SPAN:
            span = (start, start + dur)
        else:
            host.append((start, start + dur, name))
    return (np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64),
            names, b1_n, b1_ns, host, span)


def _innermost(host):
    """The host timeline as segments, each labelled by the innermost
    host record open in it: ``(starts, ends, labels)``."""
    host.sort(key=lambda h: (h[0], -h[1]))
    seg_s, seg_e, seg_l = [], [], []
    stack, now = [], None

    def emit(a, b, label):
        if b > a:
            seg_s.append(a)
            seg_e.append(b)
            seg_l.append(label)
    for s, e, name in host:
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            emit(now, end, nm)
            now = end
        if stack:
            emit(now, s, stack[-1][1])
            e = min(e, stack[-1][0])
        now = s
        stack.append((e, name))
    while stack:
        end, nm = stack.pop()
        emit(now, end, nm)
        now = end
    return (np.asarray(seg_s, np.int64), np.asarray(seg_e, np.int64),
            seg_l)


def digest(prof) -> dict | None:
    """The job's span, its device records and busy time, the host time
    outside the device's first and last record, B1's records, the
    device operations that took most time and the idle gaps summed by
    what the host was doing; ``None`` when the profile holds no job span
    or no device record."""
    dev_s, dev_e, names, b1_n, b1_ns, host, span = _records(prof)
    if span is None or not len(dev_s):
        return None
    a, b = span
    inside = (dev_e > a) & (dev_s < b)
    dev_s, dev_e = np.clip(dev_s[inside], a, b), np.clip(dev_e[inside], a, b)
    order = np.argsort(dev_s, kind="stable")
    dev_s, dev_e = dev_s[order], dev_e[order]
    reach = np.maximum.accumulate(dev_e)
    new = np.ones(len(dev_s), bool)
    new[1:] = dev_s[1:] > reach[:-1]
    seg_start = dev_s[new]
    seg_end = np.append(reach[np.nonzero(new)[0][1:] - 1], reach[-1])
    busy_ns = int((seg_end - seg_start).sum())
    gap_s = np.concatenate([[a], seg_end])
    gap_e = np.concatenate([seg_start, [b]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    hs, he, hl = _innermost(host)
    labels = sorted(set(hl)) + ["host_untraced"]
    index = {x: i for i, x in enumerate(labels)}
    ids = np.fromiter((index[x] for x in hl), np.int64, len(hl))
    mid = (gap_s + gap_e) // 2
    at = np.searchsorted(hs, mid, side="right") - 1
    ok = at >= 0
    ok[ok] = he[at[ok]] > mid[ok]
    gid = np.full(len(mid), len(labels) - 1, np.int64)
    gid[ok] = ids[at[ok]]
    sums = np.bincount(gid, weights=(gap_e - gap_s).astype(np.float64),
                       minlength=len(labels))
    gaps = {labels[i]: int(v) for i, v in enumerate(sums) if v > 0}
    graph_launches = sum(1 for h in host if h[2] == "cudaGraphLaunch")
    top_ops = sorted(names.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "span_s": (b - a) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_s": sum(names.values()) / 1e9,
        "records": int(inside.sum()),
        "frontdoor_s": (int(dev_s[0]) - a + b - int(reach[-1])) / 1e9,
        "b1_records": b1_n,
        "b1_device_s": b1_ns / 1e9,
        "graph_launches": graph_launches,
        "breakdown": {
            "device_ops": [[n, ns / 1e9] for n, ns in top_ops],
            "idle_gaps": [[n[:64], ns / 1e9] for n, ns in top_gaps]},
    }
