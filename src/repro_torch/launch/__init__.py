"""Launchers: mesh construction, input specs, the raw step functions
(``launch.steps``), and the command-line entry points of the port
(``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train``)."""
from .mesh import (CHIPS_MULTI_POD, CHIPS_SINGLE_POD, HBM_BW, ICI_BW,
                   PEAK_FLOPS_BF16, make_host_mesh, make_production_mesh)

__all__ = ["make_production_mesh", "make_host_mesh", "PEAK_FLOPS_BF16",
           "HBM_BW", "ICI_BW", "CHIPS_SINGLE_POD", "CHIPS_MULTI_POD"]
