"""The plain reference of the benchmark's configurations, in numpy: the
yardstick that decides ``correct``.  It imports nothing of the program
and takes nothing the program made: each lane's pools, capacities and
prices are worked out here again from the lane's parameters."""
from __future__ import annotations

from .cluster import run_lane
from .pool import bf16, f32
from .result import price

PRECISIONS = {"float32": f32, "bfloat16": bf16}


def lane_answer(lane: dict, trace: dict, rng_seed: int,
                precision: str = "float32") -> dict:
    """Everything the comparison reads of one lane: the per-event
    ``node`` and ``outcome``, an autoscaled lane's ``fracs`` and
    ``active``, and the priced ``latencies``, ``per_node`` and
    ``summary``."""
    out = run_lane(lane, trace, PRECISIONS[precision])
    out.update(price(lane, trace, out["node"], out["outcome"], rng_seed,
                     out.get("fracs"), out.get("active")))
    return out
