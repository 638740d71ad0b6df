"""Hand-written CUDA kernels of the port, each with its plain version.

=====================  ==========================  ======================
kernel                 replaces (TPU, Pallas)      wrapper / plain
=====================  ==========================  ======================
pool_step.evict_place  repro/kernels/pool_step.py  ``evict_place_cuda`` /
                       ``_evict_place_kernel``     ``evict_place_plain``
=====================  ==========================  ======================

Kernels are built from ``csrc/`` at first use (:mod:`._build`); importing
this package builds nothing.  Each wrapper counts its launches in a
``launches`` attribute.
"""
