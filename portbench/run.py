"""Run one cell of the benchmark of ``repro_torch`` on this machine's
CUDA device and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <window> --trace <0|1>

Run it from the root of a checkout; see ``portbench/README.md``.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness import main
    sys.exit(main(t0=T0))
