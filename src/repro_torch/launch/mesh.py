"""Device meshes; port of ``repro.launch.mesh``.

``make_production_mesh`` is a FUNCTION (not a module-level constant) so
importing this module touches no process group or device.  Both
functions build a ``torch.distributed`` ``DeviceMesh`` through
``init_device_mesh``, with the reference's shapes and axis names.

Target hardware (roofline constants): one NVIDIA H100 SXM (the card the
port is measured on: NVIDIA H100 80GB HBM3, 700 W), from NVIDIA's data
sheet, dense rates; single pod = 16 x 16 = 256 cards, multi-pod = 2 pods
= 512 cards.
"""
from __future__ import annotations

import math

import torch

from .._device import resolve_device

_SINGLE_POD = ((16, 16), ("data", "model"))
_MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The ``(16, 16)`` ``("data", "model")`` mesh, or ``(2, 16, 16)``
    ``("pod", "data", "model")``, over a process group that the caller
    has set up with that many ranks (raises otherwise).  ``device``: the
    CUDA device unless ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = _MULTI_POD if multi_pod else _SINGLE_POD
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of {n} ranks; it has not been set up")
    if dist.get_world_size() != n:
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of {n} ranks, not "
                           f"{dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(device=None):
    """An ``(n, 1)`` ``("data", "model")`` mesh on the run's devices: the
    CUDA device unless ``device="cpu"``; ``n`` is the process group's
    world size.  Where no process group exists, this sets up one of
    world size 1 for the whole process (``nccl`` for CUDA, ``gloo`` for
    the CPU), which stays until ``torch.distributed.destroy_process_group``
    is called."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if dev.type == "cuda":                  # the rank's card, before NCCL
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    return init_device_mesh(dev.type, (n, 1),
                            mesh_dim_names=("data", "model"))


# hardware constants (NVIDIA H100 SXM data sheet, NVIDIA H100 80GB HBM3,
# 700 W)
PEAK_FLOPS_BF16 = 989e12       # dense bf16 FLOP/s per card
HBM_BW = 3.35e12               # bytes/s per card
ICI_BW = 900e9                 # NVLink 4: bytes/s per card, all 18 links
CHIPS_SINGLE_POD = math.prod(_SINGLE_POD[0])     # 256
CHIPS_MULTI_POD = math.prod(_MULTI_POD[0])       # 512
