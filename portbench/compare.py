"""The comparison that decides ``correct``: the program's answers for
the sampled lanes of every job in the window against the reference's.

Every configuration states an exact guarantee (each lane bitwise the
scenario's own simulation), so every number compared has the limit 0:
an event whose routed node or outcome differs, and a reported value
(latency, per-node count or time, summary number, epoch split or
membership) that differs, each count once.
"""
from __future__ import annotations

import numpy as np

#: The reported numbers of a lane that are compared, beside its
#: per-event nodes and outcomes.
ARRAYS = ("latencies", "per_node", "fracs", "active")
#: Each compared number's limit.
LIMITS = {"event_mismatches": 0, "value_mismatches": 0}


def _differ(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    ne = a != b
    if a.dtype.kind == "f" and b.dtype.kind == "f":
        ne &= ~(np.isnan(a) & np.isnan(b))
    return int(ne.sum())


def lane_gaps(got: dict, want: dict) -> tuple[int, int]:
    """``(events, values)`` that differ between two answers of a lane."""
    n = len(want["node"])
    if len(got["node"]) != n or len(got["outcome"]) != n:
        events = n
    else:
        events = int(((np.asarray(got["node"]) != want["node"])
                      | (np.asarray(got["outcome"]) != want["outcome"]))
                     .sum())
    values = sum(_differ(got[k], want[k]) for k in ARRAYS if k in want)
    values += sum(_differ(got["summary"].get(k, np.nan), v)
                  for k, v in want["summary"].items())
    return events, values


def compare(jobs: list[dict], want: dict) -> dict:
    """``jobs``: the program's answers, one ``{lane: answer}`` a job;
    ``want``: the reference's ``{lane: answer}``.  Returns the numbers
    compared (``event_mismatches``, ``value_mismatches``, summed over
    jobs and lanes) and ``jobs_failed``."""
    ev = val = failed = 0
    for job in jobs:
        bad = False
        for lane, ref in want.items():
            e, v = lane_gaps(job[lane], ref)
            ev, val, bad = ev + e, val + v, bad or e > 0 or v > 0
        failed += bad
    return {"event_mismatches": ev, "value_mismatches": val,
            "jobs_failed": failed}
