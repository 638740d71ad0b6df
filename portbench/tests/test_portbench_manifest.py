"""The benchmark's manifest against its contract, and every
configuration, traffic mix and metric found by name as a file of its
own."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from portbench import generate, harness  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (REPO / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_unique():
    for group in (CELLS, METRICS, CONFIGS):
        assert len(group) == len(set(group))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_of_its_own(name):
    c = {x["name"]: x for x in BENCH["configs"]}[name]
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(name) and _line(c["source"]) and _line(c["why"])
    assert c["file"].startswith(BENCH["paths"][0] + "/")
    assert c["file"] == f"portbench/configs/{name}.json"
    assert len(c["reduced"]) <= 16
    assert all(NAME.match(k) for k in c["reduced"])
    data = generate.load_json("configs", name)
    assert data["name"] == name and data["precision"] == "float32"
    assert data["guarantees"]
    assert name in {w["config"] for w in BENCH["workloads"]}
    files = [x["file"] for x in BENCH["configs"]]
    assert files.count(c["file"]) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell) and NAME.match(w["traffic"])
    assert _line(w["why"]) and w["chips"] in (1, 4)
    assert cell == f"{w['config']}.{w['traffic']}"
    assert w["config"] in CONFIGS
    mix = generate.load_json("traffic", w["traffic"])
    assert mix["mode"] in ("gather", "vmap", "fused")
    assert set(mix) == {"why", "trace", "grid", "mode"}
    assert set(mix["trace"]) == {"duration_s", "events"}
    assert harness.WARMUP_EVENTS < mix["trace"]["events"]
    e2e = harness.cell_metrics(BENCH, cell, False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(BENCH, cell, True)


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_of_its_own(name):
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    m = per_layer.get(name) or {x["name"]: x for x in BENCH["end_to_end"]}[
        name]
    assert NAME.match(name) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(harness.reader(name))
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if name in per_layer:
        assert set(m) <= METRIC_KEYS | {"layer", "moves", "workloads"}
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        e2e = {x["name"] for x in BENCH["end_to_end"]}
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(
                BENCH, cell, False)}
    else:
        assert set(m) <= METRIC_KEYS | {"bound", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        if name == "setup_s":
            assert m["bound"] == 0.25


@pytest.mark.parametrize("traffic, lanes", [
    ("plan540-fused", 540), ("plan540-gather", 540),
    ("adapt243-fused", 243)])
def test_grid_sizes(traffic, lanes):
    cell = next(w for w in BENCH["workloads"] if w["traffic"] == traffic)
    config = generate.load_json("configs", cell["config"])
    grid = generate.lanes(config, generate.load_json("traffic", traffic))
    assert len(grid) == lanes
    assert len({json.dumps(g, sort_keys=True) for g in grid}) == lanes


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**33 + 5])
def test_trace_from_seed(seed):
    spec = {"duration_s": 600.0, "events": 1500}
    a, b = generate.edge_trace(seed, spec), generate.edge_trace(seed, spec)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert all(len(v) == 1500 for v in a.values())
    assert np.all(np.diff(a["t"]) >= 0)
    assert a["t"].dtype == np.float32 and a["func_id"].dtype == np.int32


def test_check_sample_covers_every_swept_value():
    config = generate.load_json("configs", "kiss-edge")
    mix = generate.load_json("traffic", "plan540-fused")
    grid = generate.lanes(config, mix)
    for seed in (1, 2, 3):
        pick = generate.check_sample(grid, harness.CHECK_LANES, seed)
        assert len(pick) == harness.CHECK_LANES == len(set(pick))
        chosen = [grid[i] for i in pick]
        for key in ("node_mb", "small_frac", "replacement", "unified"):
            assert {json.dumps(g[key]) for g in chosen} == {
                json.dumps(g[key]) for g in grid}
    assert generate.check_sample(grid, 24, 5) != generate.check_sample(
        grid, 24, 6)
