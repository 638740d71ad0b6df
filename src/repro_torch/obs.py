"""The port's counters and spans.

:data:`STATS` holds the process's run counters (the block runner's
blocks, eager events and captures), updated
under a lock: a sharded sweep runs one host thread a device.

:func:`span` marks one phase of the sweep path (``sweep``,
``sweep.plan``, ``engine.load``, ``engine.run``, ``engine.epoch_end``,
``engine.readback``, ``engine.results``, ``sweep.wrap``).  Outside a
profiler it costs one check.  Under ``torch.profiler.profile`` it is a
``record_function`` range, so it lands in the profile beside the device
records, and it is kept in memory (:func:`spans`) with stamps on the
profiler's clock (``time.time_ns``, as kineto stamps host records);
opened with a CUDA ``device``, it also times its stretch of that
device's current stream with a pair of CUDA events.  Spans wrap whole
phases and loops, never one lane or one event.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

#: Run counters, for the tests, ``chip_smoke.py`` and the benchmark:
#: ``blocks`` full blocks run (on CUDA each is one graph replay),
#: ``eager_events`` the events of the chunks' remainders, ``captures``
#: graphs captured, ``capture_s`` the host seconds spent warming up and
#: capturing them.
STATS = {"blocks": 0, "eager_events": 0, "captures": 0, "capture_s": 0.0}
_STATS_LOCK = threading.Lock()


def count(key: str, n) -> None:
    """Add ``n`` to ``STATS[key]``."""
    with _STATS_LOCK:
        STATS[key] += n


class Span(NamedTuple):
    """One span: wall stamps in ns on ``time.time_ns``'s clock,
    the index in :func:`spans` of the span that enclosed it on the same
    thread (``None`` for a thread's outermost), the thread's ident, and
    the device stream's ns between the span's two CUDA events
    (``None`` without a CUDA ``device``)."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    thread: int
    device_ns: int | None


#: Spans opened under a profiler, in opening order: ``[name, start,
#: end, parent, thread, events or device ns]``.
_SPANS: list[list] = []
_SPANS_LOCK = threading.Lock()
_OPEN = threading.local()
_OFF = contextlib.nullcontext()


def span(name: str, device: torch.device | None = None):
    """A context manager that records the phase ``name`` while a
    profiler is active in the process and does nothing otherwise.

    The check reads the process-wide flag torch keeps for fast checks
    (``torch.autograd.profiler._is_profiler_enabled``), not
    ``torch.autograd._profiler_enabled()``, which is per thread: it
    reads false on a sharded sweep's host threads while their caller
    profiles."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Traced(name, device)


class _Traced:
    __slots__ = ("name", "device", "rf", "rec")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        events = None
        if self.device is not None and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        self.rec = [self.name, 0, None, stack[-1] if stack else None,
                    threading.get_ident(), events]
        with _SPANS_LOCK:
            stack.append(len(_SPANS))
            _SPANS.append(self.rec)
        # the stamps sit next to the profiler's own, inside its range
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.rec[1] = time.time_ns()
        if events is not None:
            events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        events = self.rec[5]
        if events is not None:
            events[1].record(torch.cuda.current_stream(self.device))
        _OPEN.stack.pop()
        self.rec[2] = time.time_ns()    # closed: spans() may read events
        self.rf.__exit__(*exc)
        return False


def spans() -> list[Span]:
    """Every span recorded so far, in opening order (``end_ns`` is
    ``None`` while a span is open).  A closed span's CUDA events are
    read here, once: call it after the work they time has been
    synchronized (it waits for them otherwise)."""
    with _SPANS_LOCK:
        for rec in _SPANS:
            if rec[2] is not None and isinstance(rec[5], tuple):
                a, b = rec[5]
                b.synchronize()
                rec[5] = round(a.elapsed_time(b) * 1e6)
        return [Span(*rec[:5], None if isinstance(rec[5], tuple)
                     else rec[5]) for rec in _SPANS]


def clear() -> None:
    """Forget every recorded span (a profiled run keeps them until
    then); call it with no span open."""
    with _SPANS_LOCK:
        _SPANS.clear()
