"""The cluster step's share of its roofline: the least bytes an event
of the group needs (``peaks.step_bytes``, from the shapes and the job's
outcomes) over HBM bandwidth, divided by the device time an event."""
from portbench import peaks


def read(run):
    ds = run["digests"]
    if not ds:
        return None
    events = sum(d["events"] for d in ds)
    per_event = sum(d["device_s"] for d in ds) / events
    least = peaks.step_bytes(run["events"], run["lanes"], run["nodes"],
                             run["slots"], run["hits"], run["misses"]) \
        / run["events"] / peaks.HBM_BYTES_S
    return 100.0 * least / per_event
