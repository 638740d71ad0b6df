"""repro_torch — the KiSS warm-pool simulator and its model server on
PyTorch and CUDA.

A port of the JAX package ``repro`` that keeps its module layout and
public names, so each module here has a counterpart there::

    from repro_torch.sim import Scenario, simulate
    from repro_torch.workloads import edge_trace

    res = simulate(Scenario.kiss(4096.0), edge_trace(0, 3600.0))  # on CUDA
    res.summary()["cold_start_pct"]

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
This package imports neither JAX nor ``repro``: the host-side numpy
code it shares with the reference is copied, not imported.

Ported so far:

* ``simulate`` for static, failure-injected and autoscaled scenarios,
  with telemetry and function chains, monolithic or chunked, in the
  ``"gather"``, ``"vmap"`` and
  ``"fused"`` step modes, with the fused evict-and-place step written as a CUDA kernel
  (``repro_torch.kernels.pool_step``) and, on the card, each block of
  events replayed as one CUDA graph (``repro_torch.cluster.graphs``);
* the dense serving path: ``serving.KissServer``/``UnifiedServer`` manage
  real model containers (``models``: the decoder-only transformer for
  the dense configs of ``configs``) in the paper's warm pools
  (``core.pool_ref.WarmPool``), with prefill attention and decode
  attention written as CUDA kernels (``repro_torch.kernels``), driven by
  ``python -m repro_torch.launch.serve``; ``checkpoint`` carries the JAX
  package's weights across.  MoE, SSM/hybrid, VLM and whisper models
  raise until their slices land.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
