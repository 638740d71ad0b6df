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
=======================  ===================================  =========================

B4 (the Mamba2 SSD scan) and B5 (the RWKV6 WKV recurrence) are still to
port: :mod:`.ops` raises for them.  :mod:`.ops` routes the attention
entry points by the tensor's device: the kernel on CUDA, the plain
version on the CPU.  Kernels are built from ``csrc/`` at first use
(:mod:`._build`); importing this package builds nothing.  Each wrapper
counts its launches in a ``launches`` attribute.
"""
