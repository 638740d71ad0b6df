"""Device resolution and the run's explicit host<->device sync points."""
from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def sync_point(device: torch.device):
    """Mark a deliberate host<->device copy at the edge of a run.

    The per-event loop never synchronizes with the device; a caller may
    prove that with ``torch.cuda.set_sync_debug_mode("error")``.  Loading
    the inputs and copying the results back do synchronize, so they run
    inside this block, which lifts the debug mode and restores it."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
