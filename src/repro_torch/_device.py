"""Device resolution and the run's explicit host<->device sync points."""
from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device.  Without CUDA this raises instead
    of falling back: a CPU run is always asked for (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA or CPU device, got {dev}")
    return dev


#: How many sync points are open across threads, and the debug mode the
#: first of them lifted (the mode is process-global: the last to close
#: restores it, so one shard's thread never turns the guard back on
#: while another's is inside its sync point).
_SYNC = {"depth": 0, "mode": 0}
_SYNC_LOCK = threading.Lock()


@contextlib.contextmanager
def sync_point(device: torch.device):
    """Mark a deliberate host<->device copy at the edge of a run.

    The per-event loop never synchronizes with the device; a caller may
    prove that with ``torch.cuda.set_sync_debug_mode("error")``.  Loading
    the inputs and copying the results back do synchronize, so they run
    inside this block, which lifts the debug mode on the first entry of
    any thread and restores it on the last exit."""
    if device.type != "cuda":
        yield
        return
    with _SYNC_LOCK:
        if _SYNC["depth"] == 0:
            _SYNC["mode"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
        _SYNC["depth"] += 1
    try:
        yield
    finally:
        with _SYNC_LOCK:
            _SYNC["depth"] -= 1
            if _SYNC["depth"] == 0:
                torch.cuda.set_sync_debug_mode(_SYNC["mode"])
