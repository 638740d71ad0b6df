"""Device stream time of one re-split of the epoch loop, from the traced
job's ``engine.epoch_end`` spans: each span's CUDA events bracket the
autoscaler's kernels (the new splits, ``pool_resize``, spawn and retire,
the runner's commit) and any idle of the stream while the host enqueues
them, so a re-split that stalled on the host reads long.  The median of
the job's spans, in us, which one such stall does not move.  ``None``
where no span timed the device (runs without an autoscaled group)."""
import statistics

from portbench import span_reader


def read(run):
    ns = [s.device_ns for s in span_reader.job_spans(run) or []
          if s.name == "engine.epoch_end" and s.device_ns is not None]
    return 1e-3 * statistics.median(ns) if ns else None
