"""A run with its timed path broken underneath must come out as not
correct: the harness's look for a chip is skipped (the run is on the
CPU at a small size) and the rest of a run is driven as it is."""
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

from portbench import harness  # noqa: E402


def _run(cfg: str, mix: str, seed: int = 2**31 + 5) -> dict:
    return harness.run_cell(
        json.loads((DATA / f"{cfg}.json").read_text()),
        json.loads((DATA / f"{mix}.json").read_text()), seed, 0.01, False,
        "cpu", [{"name": "lane_events_per_s", "unit": "lane-events/s"}],
        time.perf_counter(), log=lambda m: None)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frozen_step(monkeypatch):
    """A step that returns its state unchanged."""
    from repro_torch.cluster import engine
    real = engine._make_step

    def make(*a, **k):
        step = real(*a, **k)

        def frozen(pools, ev, *args):
            keep = type(pools)(*(None if x is None else x.clone()
                                 for x in pools))
            _, node, outcome = step(pools, ev, *args)
            return keep, node, outcome
        return frozen
    monkeypatch.setattr(engine, "_make_step", make)


def _half_batch(monkeypatch):
    """Half of the lanes left out, their answers taken from the rest."""
    import repro_torch.sim as sim
    real = sim.sweep

    def half(trace, scenarios, **kw):
        scenarios = list(scenarios)
        done = real(trace, scenarios[:(len(scenarios) + 1) // 2], **kw)
        return [done[i % len(done)] for i in range(len(scenarios))]
    monkeypatch.setattr(sim, "sweep", half)


def _altered_answer(monkeypatch):
    """One event's outcome altered in every lane, where the lanes'
    outputs are produced."""
    from repro_torch.cluster import engine
    real = engine._lane_outputs

    def altered(*a, **k):
        out = real(*a, **k)
        for node, outcome, extras in out:
            outcome[0] = (outcome[0] + 1) % 3
        return out
    monkeypatch.setattr(engine, "_lane_outputs", altered)


FAULTS = {"step_returns_state": _frozen_step, "half_batch": _half_batch,
          "answer_altered": _altered_answer}


@pytest.mark.parametrize("cfg, mix", [("tiny-node", "tiny-grid"),
                                      ("tiny-cluster", "tiny-route")])
def test_sound_run_is_correct(cfg, mix):
    out = _run(cfg, mix)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["metrics"]["lane_events_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cfg, mix", [("tiny-node", "tiny-grid"),
                                      ("tiny-node", "tiny-adapt")])
def test_fault_is_not_correct(monkeypatch, fault, cfg, mix):
    FAULTS[fault](monkeypatch)
    out = _run(cfg, mix)
    assert not out["correct"]
    assert out["failed"] == out["attempted"] >= 1
    assert out["checks"]["event_mismatches"]["value"] > 0


@pytest.mark.parametrize("lost", [1, 2])
def test_lost_records_leave_a_sound_run_correct(monkeypatch, lost):
    """Profiles whose records disagree with the runner's counts make the
    harness profile more jobs after the window; B1's launches are still
    checked against the window's jobs alone.  The CPU's plain decision
    is counted as B1's launches are on the card, and the first ``lost``
    digests disagree."""
    from repro_torch.kernels import pool_step
    from portbench import trace_reader
    plain = pool_step.evict_place_plain

    def counted(*a):
        pool_step.add_launches(1)
        return plain(*a)
    monkeypatch.setattr(pool_step, "evict_place_plain", counted)
    monkeypatch.setattr(harness, "B1_DEVICES", ("cuda", "cpu"))
    calls = []

    def digest(prof):
        calls.append(prof)
        c = prof.portbench_counts
        return {"span_s": 1.0, "busy_s": 0.5, "device_s": 0.5,
                "records": 10, "frontdoor_s": 0.1,
                "b1_records": c["b1"] - (len(calls) <= lost),
                "b1_device_s": 0.1, "graph_launches": c["blocks"],
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    monkeypatch.setattr(trace_reader, "digest", digest)
    mix = json.loads((DATA / "tiny-grid.json").read_text())
    mix["mode"] = "fused"
    out = harness.run_cell(
        json.loads((DATA / "tiny-node.json").read_text()), mix, 2**31 + 9,
        0.01, True, "cpu", [{"name": "kernels_per_event",
                             "unit": "records/event"}],
        time.perf_counter(), log=lambda m: None)
    assert len(calls) == min(lost + 1, harness.TRACE_ATTEMPTS)
    assert out["checks"]["b1_launch_gap"]["value"] == 0
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 + len(calls)
    assert ("kernels_per_event" in out["metrics"]) == (
        lost < harness.TRACE_ATTEMPTS)
