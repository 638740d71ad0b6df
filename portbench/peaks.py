"""The card's peaks and the least work of each measured step, from
shapes and outcomes alone: the yardstick that the roofline shares are
taken against.

Peaks are NVIDIA's data sheet for one H100 SXM (80 GB HBM3) at its 700 W
power limit: 3.35 TB/s of HBM bandwidth and 67 TFLOP/s of float32
outside the tensor cores.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12

#: Bytes of one pool slot's fields: function id, size, last use,
#: frequency, GreedyDual priority, busy-until and launch order (4 B
#: each) and the valid flag (1 B).
SLOT_BYTES = 7 * 4 + 1
#: Bytes of one pool row's scalars: capacity, free, clock, next launch
#: number, policy code.
ROW_BYTES = 5 * 4
#: What a hit writes of its slot: last use, frequency, priority,
#: busy-until.
HIT_BYTES = 4 * 4
#: What a miss writes: the placed slot and the row's free, clock and
#: next launch number.
MISS_BYTES = SLOT_BYTES + 3 * 4
#: Per node and lane, what routing reads: the target pool's free and
#: capacity (4 B each) and the unified flag (1 B).
ROUTE_BYTES = 4 + 4 + 1
#: Per event, the invocation's columns every lane reads: time, function,
#: size, class, warm and cold durations and the two node hashes.
EVENT_BYTES = 8 * 4
#: Per event and lane, the routed node and the outcome written.
OUT_BYTES = 4 + 4


def step_bytes(events: int, lanes: int, nodes: int, slots: int,
               hits: int, misses: int) -> int:
    """The least bytes ``events`` events of a sweep group move, whatever
    kernels implement the step: each event's columns once; a lane's
    routing scalars of every node, the routed pool row's slot fields and
    scalars read once, its outputs written once; what each hit and each
    miss changes written once (a drop changes nothing).  ``hits`` and
    ``misses`` are summed over lanes and events."""
    per_lane = nodes * ROUTE_BYTES + slots * SLOT_BYTES + ROW_BYTES \
        + OUT_BYTES
    return (events * EVENT_BYTES + events * lanes * per_lane
            + hits * HIT_BYTES + misses * MISS_BYTES)


def evict_place_bound_s(p: int, s: int) -> float:
    """Least time for one evict-and-place decision over ``p`` pool rows
    of ``s`` slots: the larger of its bytes (priority, launch order and
    size f32 and the idle and valid flags in, the evict flag out, per
    slot; the deficit in and freed, insert slot, available and empty out,
    per row) over HBM, and the float32 operations of a sort of each
    row's slots (``s * ceil(log2 s)`` compares of two operations), its
    prefix sum and compare, the freed and available sums and the
    first-empty search (one operation a slot each) over the f32 peak."""
    nbytes = p * s * (4 + 4 + 4 + 1 + 1 + 1) + p * (4 + 4 + 4 + 4 + 1)
    ops = p * (2 * s * max(1, (s - 1).bit_length()) + 5 * s)
    return max(nbytes / HBM_BYTES_S, ops / F32_OPS_S)
