"""The reduction from a profile to the per-layer numbers, on a synthetic
profile, and the readers and bounds on numbers worked out by hand."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from portbench import harness, peaks, trace_reader  # noqa: E402


class _Ev:
    def __init__(self, name, start, dur, cuda, annotation=False):
        from torch.autograd import DeviceType
        self._n, self._s, self._d = name, start, dur
        self._t = DeviceType.CUDA if cuda else DeviceType.CPU
        self._a = annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _job():
    """A job span of 1,000 ns: host set-up to 100, two graph launches,
    kernels at [100, 300), [250, 400) (overlapping), [500, 600) and B1
    at [700, 800), the read-back after 800."""
    return [
        _Ev(trace_reader.JOB_SPAN, 0, 1000, False, True),
        _Ev(trace_reader.JOB_SPAN, 100, 700, True, True),
        _Ev("aten::cat", 10, 80, False),
        _Ev("cudaGraphLaunch", 95, 10, False),
        _Ev("cudaGraphLaunch", 420, 100, False),
        _Ev("cudaStreamSynchronize", 610, 200, False),
        _Ev("k_a", 100, 200, True), _Ev("k_b", 250, 150, True),
        _Ev("k_a", 500, 100, True),
        _Ev("void evict_place_kernel<x>", 700, 100, True),
        _Ev("aten::copy_", 850, 100, False),
    ]


def test_digest_by_hand():
    d = trace_reader.digest(_prof(_job()))
    assert d["span_s"] == pytest.approx(1e-6)
    assert d["busy_s"] == pytest.approx(500e-9)
    assert d["device_s"] == pytest.approx(550e-9)
    assert d["records"] == 4
    assert d["frontdoor_s"] == pytest.approx(300e-9)
    assert (d["b1_records"], d["graph_launches"]) == (1, 2)
    assert d["b1_device_s"] == pytest.approx(100e-9)
    gaps = dict(d["breakdown"]["idle_gaps"])
    # each gap goes whole to what the host was doing at its middle
    assert gaps["aten::cat"] == pytest.approx(100e-9)
    assert gaps["aten::copy_"] == pytest.approx(200e-9)
    assert gaps["cudaGraphLaunch"] == pytest.approx(100e-9)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(100e-9)
    assert sum(gaps.values()) == pytest.approx(500e-9)
    ops = dict(d["breakdown"]["device_ops"])
    assert ops["k_a"] == pytest.approx(300e-9)
    assert trace_reader.JOB_SPAN not in ops


def test_digest_without_device_records():
    events = [e for e in _job() if not e._t.name == "CUDA"]
    assert trace_reader.digest(_prof(events)) is None
    assert trace_reader.digest(_prof(_job()[1:])) is None


def _run(digests):
    return {"lanes": 2, "events": 10, "jobs": 3, "window_s": 2.0,
            "setup_s": 5.0, "peak_bytes": 2e9, "nodes": 1,
            "slots": 8, "digests": digests, "hits": 6, "misses": 10}


def test_readers_by_hand():
    d = trace_reader.digest(_prof(_job()))
    d["events"] = 10
    run = _run([d])
    got = {m["name"]: harness.reader(m["name"])(run)
           for m in harness.manifest()["end_to_end"]
           + harness.manifest()["per_layer"]}
    assert got["lane_events_per_s"] == 30.0
    assert got["peak_device_gb"] == 2.0 and got["setup_s"] == 5.0
    assert got["kernels_per_event"] == pytest.approx(0.4)
    assert got["device_us_per_event"] == pytest.approx(0.055)
    assert got["frontdoor_ms_per_job"] == pytest.approx(3e-4)
    assert got["device_idle_pct"] == pytest.approx(50.0)
    least = peaks.step_bytes(10, 2, 1, 8, 6, 10) / 10 / peaks.HBM_BYTES_S
    assert got["step_roofline_pct"] == pytest.approx(100 * least / 55e-9)
    assert got["b1_roofline_pct"] == pytest.approx(
        100 * peaks.evict_place_bound_s(4, 8) / 100e-9)


def test_readers_find_nothing_to_read():
    run = _run([])
    for m in harness.manifest()["per_layer"]:
        assert harness.reader(m["name"])(run) is None
    d = trace_reader.digest(_prof(_job()))
    d.update(events=10, b1_records=0, b1_device_s=0.0)
    assert harness.reader("b1_roofline_pct")(_run([d])) is None


def test_bounds_by_hand():
    # 1,080 rows of 1,024 slots: the bytes bound (16.6 MB over HBM)
    b = peaks.evict_place_bound_s(1080, 1024)
    assert b == pytest.approx((1080 * 1024 * 15 + 1080 * 17) / 3.35e12)
    # one lane, one node, one event, a hit: columns, routing, the row
    # read, the hit's slot fields and the outputs
    assert peaks.step_bytes(1, 1, 1, 4, 1, 0) == 32 + 9 + 4 * 29 + 20 + 8 \
        + 16
