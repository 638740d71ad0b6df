"""The harness on the card at a small size: a traced run whose profile
agrees with the block runner's counts, and a correct result."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = REPO / "portbench" / "tests" / "data"
sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402

PER_LAYER = [m for m in harness.manifest()["per_layer"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.set_caches()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "gather"])
def test_traced_run_on_the_card(card, mode):
    cfg = json.loads((DATA / "tiny-node.json").read_text())
    mix = json.loads((DATA / "tiny-grid.json").read_text())
    mix["mode"] = mode
    out = harness.run_cell(cfg, mix, 2**31 + 3, 0.5, True, "cuda",
                           PER_LAYER, time.perf_counter(),
                           log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    got = set(out["metrics"])
    assert {"kernels_per_event", "device_us_per_event",
            "frontdoor_ms_per_job", "step_roofline_pct",
            "device_idle_pct"} <= got
    assert ("b1_roofline_pct" in got) == (mode == "fused")
    for name in ("step_roofline_pct", "b1_roofline_pct"):
        if name in got:
            assert 0 < out["metrics"][name]["value"] <= 105
    assert len(out["breakdown"]["device_ops"]) <= 10
