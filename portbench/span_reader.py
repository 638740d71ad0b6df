"""From the program's own spans (``repro_torch.obs.spans()``) to the
numbers of the per-layer readers that read them.

The program records spans only under a profiler, and a run profiles only
the job it traces (and, where that profile lost records, up to
``harness.TRACE_ATTEMPTS`` jobs in all).  The trace's digest is that of
the last job profiled, so the readers read that job alone: the spans
under the last root ``sweep`` span.  A sharded sweep's host threads
open their own outermost spans; those that lie inside the root's
interval belong to its job, and a phase's wall is the union of its spans'
intervals, so phases that ran at once on several threads count once.  A
program that records no spans (one without ``repro_torch.obs``) gives
nothing to read.
"""
from __future__ import annotations

#: The span of one ``sweep`` call: one a job.
ROOT = "sweep"


def job_spans(run) -> list | None:
    """The closed spans of the last profiled job, its root among them;
    ``None`` where the run read no profile, the program records no spans
    or no root span closed."""
    if not run["digests"]:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    spans = obs.spans()
    roots = [i for i, s in enumerate(spans) if s.name == ROOT
             and s.parent is None and s.end_ns is not None]
    if not roots:
        return None
    root = spans[roots[-1]]

    def top(i):
        while spans[i].parent is not None:
            i = spans[i].parent
        return i

    def in_job(i):
        t = top(i)
        if t == roots[-1]:
            return True
        s = spans[t]
        return (s.thread != root.thread and s.end_ns is not None
                and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns)
    return [s for i, s in enumerate(spans)
            if s.end_ns is not None and in_job(i)]


def wall_ms(run, names) -> float | None:
    """Wall time of the last profiled job's spans called one of
    ``names``, the union of their intervals, in ms; ``None`` without a
    root span."""
    spans = job_spans(run)
    if spans is None:
        return None
    total, end = 0, None
    for a, b in sorted((s.start_ns, s.end_ns) for s in spans
                       if s.name in names):
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6
