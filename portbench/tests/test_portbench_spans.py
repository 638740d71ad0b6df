"""The readers of the program's spans (``span_reader`` and the metrics
``frontdoor_in_ms_per_job``, ``frontdoor_out_ms_per_job`` and
``epoch_end_us_per_epoch``) on spans made by hand, with numbers worked
out by hand; nothing read without a profile or from a program that
records no spans; and, on the card, a traced run that reports them and
names the front door's phases among its idle gaps."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = REPO / "portbench" / "tests" / "data"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

from portbench import harness, span_reader  # noqa: E402
from repro_torch import obs  # noqa: E402

NEW = ("frontdoor_in_ms_per_job", "frontdoor_out_ms_per_job",
       "epoch_end_us_per_epoch")
MS = 1_000_000


def _s(name, a, b, parent, thread=1, dev=None):
    """A span from ``a`` to ``b`` ms (``b`` None: still open)."""
    return obs.Span(name, a * MS, None if b is None else b * MS, parent,
                    thread, dev)


def _job(at, base, plan, load, run, back, results, wrap, epochs):
    """One job on thread 1 from ``at`` ms, its spans' parents indices
    into a list in which the job starts at ``base``: two ``sweep.plan``
    spans of ``plan`` ms each, ``load``, a run of ``run`` ms holding one
    1 ms ``engine.epoch_end`` a device time in ``epochs`` (ns), then
    ``back``, ``results`` and ``wrap`` ms."""
    out, t = [None], at

    def add(name, ms, parent, dev=None):
        nonlocal t
        out.append(_s(name, t, t + ms, parent, 1, dev))
        t += ms
    for ms in plan:
        add("sweep.plan", ms, base)
    add("engine.load", load, base)
    r = base + len(out)
    out.append(_s("engine.run", t, t + run, base))
    for k, dev in enumerate(epochs):
        out.append(_s("engine.epoch_end", t + 10 * k, t + 10 * k + 1, r, 1,
                      dev))
    t += run
    add("engine.readback", back, base)
    add("engine.results", results, base)
    add("sweep.wrap", wrap, base)
    out[0] = _s("sweep", at, t, None)
    return out


def _spans():
    """Two profiled jobs, the first rejected by the trace's cross-check:
    (10 + 20) + 100 ms in, 50 + 100 + 40 out, epochs of 5 and 7 us; then
    the digest's job: (15 + 15) + 140 in, 70 + 120 + 60 out, epochs of
    9, 4 and 30 us.  Besides, a span still open and one of another
    thread outside the last job, which no reader counts."""
    spans = _job(0, 0, (10, 20), 100, 100, 50, 100, 40, (5_000, 7_000))
    spans += _job(5_000, len(spans), (15, 15), 140, 150, 70, 120, 60,
                  (9_000, 4_000, 30_000))
    spans.append(_s("engine.load", 9_000, None, None))
    spans.append(_s("engine.load", 6_000, 6_100, None, thread=2))
    return spans


def _sharded():
    """One job whose lanes ran on two host threads (2 and 3) at once:
    20 ms of plan on thread 1, loads of 20-120 and 40-160 ms and
    read-backs of 300-330 and 310-350 ms on the shard threads, then 40
    ms of results and 10 of wrap on thread 1."""
    return [_s("sweep", 0, 400, None),
            _s("sweep.plan", 0, 20, 0),
            _s("engine.load", 20, 120, None, thread=2),
            _s("engine.load", 40, 160, None, thread=3),
            _s("engine.run", 120, 300, None, thread=2),
            _s("engine.run", 160, 310, None, thread=3),
            _s("engine.readback", 300, 330, None, thread=2),
            _s("engine.readback", 310, 350, None, thread=3),
            _s("engine.results", 350, 390, 0),
            _s("sweep.wrap", 390, 400, 0)]


@pytest.fixture
def hand_spans(monkeypatch):
    monkeypatch.setattr(obs, "spans", _spans)


def _run(digests=({"events": 1},)):
    return {"digests": list(digests)}


def test_readers_on_spans_made_by_hand(hand_spans):
    got = {name: harness.reader(name)(_run()) for name in NEW}
    # the second job alone: in 30 + 140, out 70 + 120 + 60, the median
    # of 9, 4 and 30 us (their mean would read 14.33)
    assert got == pytest.approx({"frontdoor_in_ms_per_job": 170.0,
                                 "frontdoor_out_ms_per_job": 250.0,
                                 "epoch_end_us_per_epoch": 9.0})
    assert [s.name for s in span_reader.job_spans(_run())][:2] == [
        "sweep", "sweep.plan"]
    assert len(span_reader.job_spans(_run())) == 11


def test_readers_take_the_union_of_threads(monkeypatch):
    monkeypatch.setattr(obs, "spans", _sharded)
    got = {name: harness.reader(name)(_run()) for name in NEW[:2]}
    assert harness.reader("epoch_end_us_per_epoch")(_run()) is None
    # in: 20 + (120 - 20 with 160 - 40 overlapping) = 20 + 140; out:
    # 300-350 on the shards, 50, + 40 + 10
    assert got == pytest.approx({"frontdoor_in_ms_per_job": 160.0,
                                 "frontdoor_out_ms_per_job": 100.0})
    assert len(span_reader.job_spans(_run())) == len(_sharded())


def test_hand_spans_nest():
    for spans in (_spans(), _sharded()):
        for s in spans:
            if s.parent is not None:
                p = spans[s.parent]
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
                assert p.name == ("engine.run"
                                  if s.name == "engine.epoch_end"
                                  else "sweep")
    assert [s.name for s in _spans() if s.parent is None] == [
        "sweep", "sweep", "engine.load", "engine.load"]


def test_nothing_without_a_profile(hand_spans):
    assert span_reader.job_spans(_run(())) is None
    for name in NEW:
        assert harness.reader(name)(_run(())) is None


def test_nothing_from_a_program_without_spans(monkeypatch):
    """A program older than ``repro_torch.obs`` (the import fails) gives
    every new reader nothing, without raising."""
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert span_reader.job_spans(_run()) is None
    for name in NEW:
        assert harness.reader(name)(_run()) is None


def test_no_epoch_without_device_times(monkeypatch):
    """Spans with no device time (a CPU run) and no root give nothing."""
    spans = [s._replace(device_ns=None) for s in _spans()]
    monkeypatch.setattr(obs, "spans", lambda: spans)
    assert harness.reader("epoch_end_us_per_epoch")(_run()) is None
    monkeypatch.setattr(obs, "spans", lambda: [
        s._replace(name="x") if s.name == "sweep" else s for s in spans])
    assert harness.reader("frontdoor_in_ms_per_job")(_run()) is None


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.set_caches()


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["tiny-grid", "tiny-adapt"])
def test_traced_run_reads_the_spans(card, traffic):
    cfg = json.loads((DATA / "tiny-node.json").read_text())
    mix = json.loads((DATA / f"{traffic}.json").read_text())
    mix["mode"] = "fused"
    obs.clear()
    out = harness.run_cell(cfg, mix, 2**31 + 5, 0.5, True, "cuda",
                           harness.manifest()["per_layer"],
                           time.perf_counter(), log=lambda m: None)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    want = set(NEW) if traffic == "tiny-adapt" else set(NEW[:2])
    assert want <= set(got)
    assert all(got[n]["value"] > 0 for n in want)
    gaps = {name for name, _ in out["breakdown"]["idle_gaps"]}
    assert gaps & {"engine.load", "engine.readback"}, gaps
    obs.clear()
