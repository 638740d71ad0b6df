"""Host time of a profiled job outside the card's work: from the job's
start to its first device record, and from its last device record to
the job's end (the front door's grouping, stacking and upload, then its
read-back and each lane's ``Result``), in ms."""


def read(run):
    ds = run["digests"]
    return 1e3 * sum(d["frontdoor_s"] for d in ds) / len(ds) if ds else None
