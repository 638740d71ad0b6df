"""Hand-written CUDA kernels of the port, each with its plain version.

=======================  ===================================  =========================
kernel                   replaces (TPU, Pallas)               wrapper / plain
=======================  ===================================  =========================
B1 pool_step             repro/kernels/pool_step.py           ``evict_place_cuda`` /
   (``csrc/pool_step.cu``)  ``_evict_place_kernel``          ``evict_place_plain``
B2 decode_attention      repro/kernels/decode_attention.py    ``decode_attention_cuda`` /
   (split-KV + combine)    ``_kernel``                         ``decode_attention_plain``
B3 flash_attention       repro/kernels/flash_attention.py     ``flash_attention_cuda`` /
   (prefill)               ``_kernel``                         ``flash_attention_plain``
B4 ssm_scan              repro/kernels/ssm_scan.py            ``ssm_scan_cuda`` /
   (Mamba2 SSD, chunked)   ``_kernel``                         ``ssm_scan_plain``
B5 wkv6                  repro/kernels/wkv6.py                ``wkv6_cuda`` /
   (RWKV6 recurrence)      ``_kernel``                         ``wkv6_plain``
=======================  ===================================  =========================

:mod:`.ops` routes each entry point by the tensor's device: the kernel on
CUDA, the plain version on the CPU.  Where a gradient is needed, B3, B4
and B5 run inside autograd Functions whose backward is plain torch
(``flash_attention_bwd``, ``ssm_scan_bwd``, ``wkv6_bwd``).  Kernels are built from ``csrc/`` at
first use (:mod:`._build`); importing this package builds nothing.  Each
wrapper counts its launches in a ``launches`` attribute.
"""
