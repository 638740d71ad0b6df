"""Kernel B1's share of the evict-and-place decision's roofline: the
least time of one decision over all of the group's pool rows
(``peaks.evict_place_bound_s``) over the profiler's device time a B1
launch.  ``None`` where no B1 record was read (modes other than
``fused``)."""
from portbench import peaks


def read(run):
    ds = [d for d in run["digests"] if d["b1_records"]]
    if not ds:
        return None
    per_launch = sum(d["b1_device_s"] for d in ds) \
        / sum(d["b1_records"] for d in ds)
    rows = run["lanes"] * 2 * run["nodes"]
    return 100.0 * peaks.evict_place_bound_s(rows, run["slots"]) / per_launch
