"""Device records (kernels, copies, sets) of a profiled job over its
trace events; read only from a profile whose records agree with the
block runner's own counts (graph replays, B1 launches)."""


def read(run):
    ds = run["digests"]
    return sum(d["records"] for d in ds) / sum(d["events"] for d in ds) \
        if ds else None
