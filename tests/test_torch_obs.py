"""The port's counters and spans (``repro_torch.obs``) on a tiny
``sweep`` on the CPU, through the block runner run eagerly: a plain
group in chunks and an autoscaled group.

With no profiler, no span is kept and ``record_function`` is never
entered.  Under ``torch.profiler.profile``: the spans nest as the sweep
path's phases do, each lies within 100 us of its ``record_function``
record on the profiler's clock, the epoch loop's spans match the
trace's full epochs, and the results are
bitwise those of a run with no profiler.  The parent of a span is
tracked per thread.  On the card (``cuda``), an ``engine.epoch_end``
span times the device stream.  No JAX: the file runs on the GPU host.
"""
import functools
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.sim as T
from repro_torch import obs
from repro_torch.cluster import engine, graphs
from repro_torch.sim import api
from repro_torch.workloads import edge_trace

K = 8                   # events a block of the runner
EPOCH = 32
CHUNK = 64
ROOT_KIDS = ["sweep.plan", "sweep.plan", "sweep.plan", "engine.load",
             "engine.run", "engine.readback", "engine.results",
             "sweep.wrap"]


@pytest.fixture(scope="module")
def trace():
    return edge_trace(seed=0, duration_s=60.0)     # 158 events


def _scenarios(kind):
    if kind == "plain":
        return [T.Scenario.kiss(gb * 1024.0, small_frac=f)
                for gb in (2, 4) for f in (0.8, 0.6)]
    return [T.Scenario.kiss(gb * 1024.0, small_frac=0.7,
                            autoscale=T.Autoscale(epoch_events=EPOCH))
            for gb in (2, 4)]


@pytest.fixture
def runner_path(monkeypatch):
    """``sweep``'s groups through the block runner at K events a block
    (eagerly on the CPU), the autoscaled one too."""
    for name in ("_run_group", "_run_group_autoscale"):
        monkeypatch.setattr(api, name, functools.partial(
            getattr(engine, name), block_events=K))


def _sweep(kind, trace, device="cpu"):
    return T.sweep(trace, _scenarios(kind), device=device,
                   chunk_events=CHUNK if kind == "plain" else None)


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.node, y.node)
        np.testing.assert_array_equal(x.outcome, y.outcome)
        assert x.summary() == y.summary()
        assert (x.fracs is None) == (y.fracs is None)
        if x.fracs is not None:
            np.testing.assert_array_equal(x.fracs, y.fracs)


def _profiled(kind, trace, device="cpu"):
    obs.clear()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device != "cpu" else [])
    with profile(activities=acts) as prof:
        res = _sweep(kind, trace, device)
    return res, obs.spans(), prof


def test_counters_are_one_dict():
    assert graphs.STATS is obs.STATS
    assert set(obs.STATS) == {"blocks", "eager_events", "captures",
                              "capture_s"}


@pytest.mark.parametrize("kind", ["plain", "autoscaled"])
def test_no_span_without_a_profiler(trace, runner_path, monkeypatch, kind):
    want = _sweep(kind, trace)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(obs, "record_function", refuse)
    obs.clear()
    got = _sweep(kind, trace)
    assert obs.spans() == []
    assert obs.span("sweep") is obs.span("engine.run")  # one shared no-op
    _assert_same(want, got)


@pytest.mark.parametrize("kind", ["plain", "autoscaled"])
def test_spans_nest_as_the_phases(trace, runner_path, kind):
    want = _sweep(kind, trace)
    got, spans, _ = _profiled(kind, trace)
    _assert_same(want, got)
    n_epochs = len(trace) // EPOCH if kind == "autoscaled" else 0
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns
               and s.thread == threading.get_ident()
               and s.device_ns is None for s in spans)
    assert spans[0].name == "sweep" and spans[0].parent is None
    kids = [s.name for s in spans if s.parent == 0]
    assert kids == ROOT_KIDS
    ends = [i for i, s in enumerate(spans) if s.name == "engine.epoch_end"]
    assert len(ends) == n_epochs
    run = [i for i, s in enumerate(spans) if s.name == "engine.run"]
    assert all(spans[i].parent == run[0] for i in ends)
    assert len(spans) == 1 + len(ROOT_KIDS) + n_epochs
    for s in spans[1:]:
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    kid_spans = [s for s in spans if s.parent == 0]
    for a, b in zip(kid_spans, kid_spans[1:]):
        assert a.end_ns <= b.start_ns


def _offsets_us(spans, prof):
    """Each span's start and end against its ``record_function`` record
    (the n-th record of a name is the n-th span of that name), in us."""
    recs: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in {s.name for s in spans}:
            recs.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    for v in recs.values():
        v.sort()
    seen: dict = {}
    out = []
    for s in spans:
        i = seen[s.name] = seen.get(s.name, -1) + 1
        a, b = recs[s.name][i]
        out.append((abs(s.start_ns - a) / 1e3, abs(s.end_ns - b) / 1e3))
    assert all(len(recs[n]) == seen[n] + 1 for n in seen)
    return out


@pytest.mark.parametrize("kind", ["plain", "autoscaled"])
def test_spans_on_the_profilers_clock(trace, runner_path, kind):
    """A thread descheduled between a stamp and the profiler's own can
    push one offset past the limit on a loaded host: such a run is
    profiled again, three runs at most."""
    _profiled(kind, trace)          # the profiler's first-use costs
    worst = []
    for _ in range(3):
        _, spans, prof = _profiled(kind, trace)
        offsets = _offsets_us(spans, prof)
        worst.append(max(max(o) for o in offsets))
        if worst[-1] <= 100.0:
            break
    assert worst[-1] <= 100.0, worst


def test_parents_are_tracked_per_thread():
    """16 threads open nested spans at once under one profiler (a
    sharded sweep's host threads): every span's parent is its own
    thread's enclosing span."""
    obs.clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(i):
        try:
            for _ in range(20):
                with obs.span(f"outer{i}"):
                    with obs.span(f"inner{i}"):
                        pass
        except Exception as e:      # reported below, not lost in a thread
            errors.append(e)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    spans = obs.spans()
    assert len(spans) == 16 * 20 * 2
    for s in spans:
        if s.name.startswith("outer"):
            assert s.parent is None
        else:
            p = spans[s.parent]
            assert p.name == "outer" + s.name[len("inner"):]
            assert p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    obs.clear()
    assert obs.spans() == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_epoch_end_times_the_device(card, trace):
    """On the card each ``engine.epoch_end`` span carries the device
    stream's time between its CUDA events; the results match a run with
    no profiler."""
    want = _sweep("autoscaled", trace, "cuda")
    got, spans, _ = _profiled("autoscaled", trace, "cuda")
    _assert_same(want, got)
    ends = [s for s in spans if s.name == "engine.epoch_end"]
    assert len(ends) == len(trace) // EPOCH
    assert all(s.device_ns is not None and s.device_ns > 0 for s in ends)
    assert all(s.device_ns is None for s in spans
               if s.name != "engine.epoch_end")
