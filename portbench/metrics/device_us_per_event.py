"""Summed device time of a profiled job's records over its trace
events, in us."""


def read(run):
    ds = run["digests"]
    return 1e6 * sum(d["device_s"] for d in ds) / sum(d["events"] for d in ds) \
        if ds else None
