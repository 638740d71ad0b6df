"""The plain reference against the port on the CPU at a few lanes, and
the control (the reference in bfloat16 in the program's place), which
the comparison must fail."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = REPO / "portbench" / "tests" / "data"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

from portbench import compare, control, generate, harness  # noqa: E402
from portbench.reference import lane_answer  # noqa: E402
from portbench.reference.pool import bf16, f32  # noqa: E402

MIXES = {"grid": ("tiny-node", "tiny-grid"),
         "route": ("tiny-cluster", "tiny-route"),
         "adapt": ("tiny-node", "tiny-adapt")}


def _load(kind: str):
    cfg, mix = MIXES[kind]
    return (json.loads((DATA / f"{cfg}.json").read_text()),
            json.loads((DATA / f"{mix}.json").read_text()))


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind, mode", [
    ("grid", "gather"), ("grid", "fused"), ("route", "gather"),
    ("route", "vmap"), ("adapt", "gather"), ("adapt", "fused")])
def test_reference_equals_the_port(kind, mode):
    """Every lane of a small grid, run by the port's ``sweep`` on the
    CPU, equals the reference: nodes, outcomes and every reported
    number."""
    import repro_torch.sim as sim
    from repro_torch.core.types import Trace
    cfg, mix = _load(kind)
    seed = 2**31 + 17
    trace = generate.edge_trace(seed, mix["trace"])
    grid = generate.lanes(cfg, mix)
    res = sim.sweep(Trace(*(trace[k] for k in (
        "t", "func_id", "size_mb", "cls", "warm_dur", "cold_dur"))),
        [harness.scenario(sim, lane) for lane in grid], mode=mode,
        rng_seed=seed, device="cpu")
    got = {g: harness.answer(r) for g, r in enumerate(res)}
    want = {g: lane_answer(lane, trace, seed) for g, lane in enumerate(grid)}
    assert compare.compare([got], want) == {
        "event_mismatches": 0, "value_mismatches": 0, "jobs_failed": 0}
    assert set(want[0]["summary"]) <= set(got[0]["summary"])


@pytest.mark.parametrize("kind", sorted(MIXES))
def test_control_must_miss(kind):
    """The reference in bfloat16, judged as a run is judged, fails the
    comparison; the float32 reference against itself passes."""
    cfg, mix = _load(kind)
    for seed in (3, 4, 2**32 + 1):
        ctl = control.readings(cfg, mix, seed)
        assert ctl["event_mismatches"] > compare.LIMITS["event_mismatches"]
        assert ctl["jobs_failed"] == 1
        assert control.readings(cfg, mix, seed, "float32") == {
            "event_mismatches": 0, "value_mismatches": 0, "jobs_failed": 0}


@pytest.mark.parametrize("x", [0.0, 1.0, 3599.984375, 1e-7, -2.5, 123.456])
def test_rounding(x):
    assert f32(x) == float(np.float32(x))
    b = bf16(x)
    assert b == float(np.float32(b))
    assert abs(b - x) <= abs(x) * 2.0 ** -8


def test_comparison_counts_each_difference():
    a = {"node": np.zeros(4, np.int32), "outcome": np.zeros(4, np.int32),
         "latencies": np.ones(4), "per_node": np.zeros((1, 2, 4)),
         "fracs": np.ones((1, 1), np.float32),
         "active": np.ones((1, 1), bool), "summary": {"hit_rate": 50.0}}
    b = {k: (v.copy() if hasattr(v, "copy") else v) for k, v in a.items()}
    b["summary"] = {"hit_rate": 50.0}
    assert compare.lane_gaps(b, a) == (0, 0)
    b["outcome"] = np.array([0, 1, 0, 2], np.int32)
    b["latencies"] = np.array([1.0, 2.0, 1.0, 1.0])
    b["summary"] = {"hit_rate": 49.0}
    assert compare.lane_gaps(b, a) == (2, 2)
    b["node"] = np.zeros(3, np.int32)
    assert compare.lane_gaps(b, a)[0] == 4
