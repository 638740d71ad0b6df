"""Launchers: mesh construction, input specs, the raw and sharded step
functions (``launch.steps``), the dry-run, and the command-line entry
points of the port (``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train``, ``python -m repro_torch.launch.dryrun``).

``dryrun`` is not imported here, as in the reference: run it as
``python -m repro_torch.launch.dryrun``."""
from .mesh import (CHIPS_MULTI_POD, CHIPS_SINGLE_POD, HBM_BW, ICI_BW,
                   PEAK_FLOPS_BF16, make_host_mesh, make_production_mesh)

__all__ = ["make_production_mesh", "make_host_mesh", "PEAK_FLOPS_BF16",
           "HBM_BW", "ICI_BW", "CHIPS_SINGLE_POD", "CHIPS_MULTI_POD"]
