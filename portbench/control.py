"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the next precision below the one the
configuration states (bfloat16 for float32), judged by the same
comparison as a run.  It has to come out as not correct; its readings
are the upper ends the limits are set below.

    python3 portbench/control.py --workload <cell> --seed <n> [...]

prints, for each seed, the numbers compared for the control and for the
float32 reference against itself.  It needs no card and imports nothing
of the program.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def readings(config: dict, mix: dict, seed: int,
             precision: str = "bfloat16") -> dict:
    """The numbers compared when the reference in ``precision`` takes
    the program's place, over the lanes a run with ``seed`` checks."""
    from portbench import compare, generate, harness
    from portbench.reference import lane_answer
    trace = generate.edge_trace(seed, mix["trace"])
    grid = generate.lanes(config, mix)
    sample = generate.check_sample(
        grid, mix.get("check_lanes", harness.CHECK_LANES), seed)
    want = {g: lane_answer(grid[g], trace, seed) for g in sample}
    got = {g: lane_answer(grid[g], trace, seed, precision) for g in sample}
    return compare.compare([got], want)


def main(argv=None) -> int:
    from portbench import generate, harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = {w["name"]: w for w in harness.manifest()["workloads"]}[
        args.workload]
    config = generate.load_json("configs", cell["config"])
    mix = generate.load_json("traffic", cell["traffic"])
    for seed in args.seed:
        t = time.perf_counter()
        row = {"workload": args.workload, "seed": seed,
               "control": readings(config, mix, seed),
               "float32": readings(config, mix, seed, "float32"),
               "seconds": round(time.perf_counter() - t, 2)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
