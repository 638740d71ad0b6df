"""Share of a profiled job's span in which no record ran on the card,
in %."""


def read(run):
    ds = run["digests"]
    if not ds:
        return None
    return 100.0 * (1.0 - sum(d["busy_s"] for d in ds)
                    / sum(d["span_s"] for d in ds))
