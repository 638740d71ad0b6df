"""Nothing the benchmark runs reaches JAX or the JAX package, compared
by whole top-level name (``repro_torch`` starts with ``repro``), and the
reference reaches nothing of the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
HERE = REPO / "portbench"
sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402

SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("modules, bad", [
    (["repro_torch", "repro_torch.sim", "numpy", "jaxtyping_like"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.sim.api", "torch"], ["repro.sim.api"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]),
    (["reprolib", "jaxx", "flaxen"], []),
])
def test_whole_word_check(modules, bad):
    assert harness.forbidden_modules(dict.fromkeys(modules)) == bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_sources_import_no_jax(path):
    names = _imports(path)
    assert not names & set(harness.FORBIDDEN)
    assert "benchmarks" not in names
    if "reference" in path.parts:
        assert not names & {"repro_torch", "torch", "portbench"}


def test_reference_alone_loads_no_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference, portbench.control, json; "
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('torch', 'repro_torch', 'repro', 'jax'))))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []


def test_cpu_run_loads_no_jax():
    """A whole run on the CPU, in a fresh process (the test workers
    import JAX for other tests), leaves no forbidden module loaded."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(REPO)!r})
import torch
torch.set_num_threads(1)
from portbench import harness
cfg = json.load(open({str(HERE / 'tests/data/tiny-node.json')!r}))
mix = json.load(open({str(HERE / 'tests/data/tiny-grid.json')!r}))
out = harness.run_cell(cfg, mix, 2**31 + 99, 0.05, False, "cpu", [],
                       time.perf_counter(), log=lambda m: None)
print(json.dumps([out["correct"], harness.forbidden_modules(),
                  "repro_torch" in sys.modules]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [],
                                                                True]


def test_run_refuses_without_the_program(tmp_path):
    """In a directory holding only the manifest and the harness, a run
    exits with an error and prints no result."""
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kiss-edge.plan540-fused", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
