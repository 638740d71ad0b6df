#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Needs one CUDA card and ``nvcc``; exits non-zero without them, and when
run outside a checkout.  Imports no JAX and nothing of ``repro``.
Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the five kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, all at once (timed, with ``ptxas``'s report);
3. kernel B1 against its plain torch version on tie-heavy quantized
   batches (``-0.0`` and ``+0.0`` priorities among them) at the
   simulator's shapes (the vertical phase's ``[8, 128]``, the sweep
   phase's ``[80, 1024]`` and ``[192, 256]`` and the oracle phase's
   ``[6, 1024]`` among them) and a ragged
   one, bitwise on every output, then
   timed per launch with CUDA events, and alone by the profiler, which
   must see its one kernel, ``evict_place_kernel``;
4. kernels B3 (flash attention) and B2 (decode attention) against their
   plain versions at the serving path's shapes (starcoder2-3b, glm4-9b,
   zamba2-1.2b's shared MHA block, granite-moe-1b-a400m and qwen2-vl-7b's
   group of 7), kimi-k2's (head dim 112, a group of 8), whisper-medium's
   non-causal encoder (1,500 frames) and cross-attention (32 queries and
   1 against 1,500 frames) and its decoder cache, long shapes and ragged
   ones, in
   bf16 (tolerance 2e-2) and f32 (2e-5), absolute and relative, the JAX
   reference's own ``TOL``; the profiler must see the tensor-core kernels
   (``flash_wgmma_kernel``, ``decode_mma_kernel``) run in bf16 and the
   CUDA-core ones (``flash_fma_kernel``, ``decode_fma_kernel``) in f32;
   then timed beside the plain version, ``scaled_dot_product_attention``
   and the bound;
5. kernels B4 (the Mamba2 SSD scan) and B5 (the RWKV6 WKV recurrence)
   against their plain versions at zamba2's and rwkv6's serving prefill
   (and rwkv6's decode, S = 1), at 4,096 steps and at a ragged length
   with a nonzero initial state, in f32 (atol 5e-4, rtol 1e-3: the
   reference's own bound for its chunked kernel against its sequential
   oracle) and bf16 (2e-2); the profiler must see B4's tensor-core kernel
   (``ssm_scan_mma_kernel``) in bf16 and its CUDA-core one
   (``ssm_scan_fma_kernel``) in f32; then timed beside the plain version
   and the bound (no single PyTorch call computes either function);
6. the simulator path: the first ``SIM_EVENTS`` (4,000) invocations of
   the README quickstart's trace, ``edge_trace(seed=0, duration_s=3600)``
   (11,215 invocations, 140 functions; stored as
   ``repro_torch.workloads.quickstart_trace``), through
   ``Scenario.kiss(4096.0)`` (2 pools x 1024 slots) and the 16-node
   ``het16_cluster("size_aware")`` (32 pools x 256 slots) in every step
   mode on the card, then the whole trace in chunks of ``CHUNK_EVENTS``
   (kiss4096 in every mode, het16 in ``fused``), under
   ``torch.cuda.set_sync_debug_mode("error")`` (no per-event host sync),
   with every count zeroed just before and read just after; each run goes
   through the block runner (``repro_torch.cluster.graphs``: each block
   of ``BLOCK_EVENTS`` events one CUDA graph replay, a chunk's remainder
   eager), whose replay and eager counts must be whole blocks and
   remainders, and B1 must launch once a fused event; every run must
   match the digests of the JAX reference (``GOLDEN`` and
   ``GOLDEN_FULL``, pinned by ``tests/test_torch_sim.py`` and
   ``tests/test_torch_replay.py``), bitwise; a CPU ``gather`` run over
   the first ``CPU_EVENTS`` of the head must match them too; each run
   prints its events/s and the share of its wall spent capturing;
   then the failure path: het16 with two node outages over the head
   (``FAIL_WINDOWS``), monolithic and in chunks of ``FAIL_CHUNK``, in
   every mode, held to ``GOLDEN_FAIL`` (digests, residents invalidated
   per node, ``downtime_pct``; pinned by
   ``tests/test_torch_failures.py``); then the autoscale path: the whole
   trace through ``autoscale_scenarios`` (kiss4096 re-splitting every
   ``ASC_EPOCH`` events; het16 with the failure windows, re-splitting
   and spawning or retiring nodes) in every mode, each epoch one chunk
   of the block runner, held to ``GOLDEN_ASC`` (pinned by
   ``tests/test_torch_autoscale.py``), with the re-split's share of the
   wall from CUDA events around each one; then telemetry and chains
   (``telemetry_phase``): the telemetry benchmark's 4-node cluster over
   the whole trace with windows of ``TEL_WINDOW`` events in every mode,
   monolithic and in chunks of ``TEL_CHUNK``, and without telemetry (the
   outcomes must not move; its overhead is printed), het16 autoscaled
   with windows, and the chain benchmark's scenarios
   (``chain_scenarios``, ``slack_aware`` and ``size_aware``) on its
   stored trace as the two lanes of one sweep in ``gather`` and in
   ``vmap`` (``slack_aware`` in ``fused`` in chunks; both in ``fused``
   as chain-grid lanes), held to
   ``GOLDEN_TEL`` and
   ``GOLDEN_CHAIN`` (every window array, every per-chain array, the
   summary; pinned by ``tests/test_torch_{telemetry,chains}.py``); then
   vertical scaling (``vertical_phase``): ``benchmarks/vertical.py``'s
   cluster and lanes on the quickstart trace (the hybrid in every mode,
   monolithic and chunked; no resize; the hybrid with outages,
   autoscaled and with telemetry; the unified ``fair_share`` lane and
   the ``static`` resize lane as one sweep), held to ``GOLDEN_RZ``
   (node, outcome, the summary with ``utilization_ratio`` and
   ``bottleneck_events``, the three ``Result.vertical`` arrays, every
   window array; pinned by ``tests/test_torch_vertical_pool.py``), with
   the ``static`` lane equal to no resize, bottleneck events in every
   ``fair_share`` run and resize's overhead printed; then sweeps
   (``sweep_phase``): the repo's own grids through ``sweep``, each
   group's lanes a tensor axis of one step and one block runner
   (``edge_grid``: ``examples/kiss_edge_sim.py``'s 48 lanes;
   ``routing_grid``: every routing on het16, whole trace and head;
   ``chain_grid``: every routing x three SLO regimes with an outage,
   monolithic and chunked; ``vertical_replay``: the unified and hybrid
   resize lanes over the whole stored replay trace in chunks of
   ``RZ_REPLAY_CHUNK``), every lane held to ``GOLDEN_SWEEP`` or
   ``GOLDEN_RZ`` (pinned by ``tests/test_torch_sweep.py``), B1 once a
   ``fused`` event of a group, with each sweep's and each group's
   lane-events/s beside one ``simulate``'s events/s; then sharded sweeps
   (``sharded_sweeps``, ``devices=k``, counts zeroed again): a
   rehearsal on this card with the device count and the shards' devices
   patched so that ``k`` shards land on ``cuda:0`` (``chain_grid`` at
   ``k = 4``, 5 lanes a shard and 2 pad lanes; the edge grid's 8
   autoscaled lanes at ``k = 3``, 1 pad lane), every lane held to
   ``GOLDEN_SWEEP`` and the tight chain lanes to ``GOLDEN_CHAIN``, B1
   once a ``fused`` event of each shard and one capture a shard shape;
   then, unpatched, ``devices=1`` and ``"all"`` equal to the unsharded
   chain grid and ``devices=count+1`` refused before any launch; with two
   cards or more the same grids across the real cards at once, their
   lane-events/s beside the unsharded groups'; then the numpy
   oracle (``oracle_phase``): the vertical benchmark's stored Azure
   tables written as the public CSVs and read back by
   ``load_azure_trace`` must equal ``trace_from_tables`` of them drawn
   here and the stored replay trace (``analyze`` of it printed), and
   card runs must equal ``sweep(..., engine="ref")`` on this host,
   bitwise: earlier phases' runs (two edge-grid lanes, a chain-grid
   lane, the failure phase's and the autoscale phase's ``fused`` runs)
   and two new ``fused`` sweeps over ``ORACLE_EVENTS`` events of traces
   drawn here, which have no JAX golden (``bursty_trace(seed=0)``, and
   the ingested replay through the vertical benchmark's hybrid lane
   with telemetry and het16); then the device's
   busy share and device records an event over two graph replays, for
   the static, the autoscaled and the resize runner, for telemetry and
   chains on and for sweeps of 1, 8 and 40 lanes, with B1's kernel
   records in ``fused`` seen at most once an event;
7. the serving path at full width: ``launch.serve.default_registry()``'s
   models but qwen2.5-32b (whose weights cannot share the card),
   starcoder2-3b, rwkv6-7b, zamba2-1.2b, glm4-9b and granite-moe-1b-a400m
   (random bf16 weights from a seed), behind one ``KissServer`` on the
   card, 16 requests through ``launch.serve.run``, with B2-B5's launch
   counts zeroed just before and read just after; they must equal the
   layers of each kind times the prefills and decode steps the requests
   ask for;
8. eviction: a ``UnifiedServer`` whose pool holds one of starcoder2-3b
   and glm4-9b at a time; after each eviction the device memory
   allocated must fall to the resident model's weights (within
   ``EVICT_MARGIN_MB``);
9. logits at full width: one ``generate`` of each model (12 prompt
   tokens, 8 new) against an f32 forward over the whole sequence without
   a cache, the port's own blocks with f32 weights and every kernel
   replaced by its plain version (see ``LOGITS_TOL``); for starcoder2-3b
   also with its window cut to 16 so that the ring and the window bind,
   and for zamba2-1.2b and rwkv6-7b a control that decodes the same
   tokens with the recurrent state zeroed before each step, which must
   miss; granite-moe-1b-a400m against the same prefill and decode steps
   in f32 plain torch (``path_logits``: an MoE layer routes each call's
   tokens as one group), its control one expert a token;
10. the families (``families_phase``), one container at a time:
   qwen2-vl-7b and whisper-medium at full width and kimi-k2-1t-a32b cut
   to ``KIMI_LAYERS`` layer; each a cold start, a ``generate`` of a
   32-token prefill and 8 decode steps whose B2/B3 launches (counts
   zeroed just before, read just after) must equal
   ``family_launches``, its peak memory, and a logits check with a
   control that must miss: qwen2-vl with stub vision patches and 3-D
   M-RoPE positions against the f32 plain forward (control: 1-D
   positions), whisper with stub audio frames against the f32 plain
   ``decode_train`` (control: a causal cross-attention), kimi-k2 against
   its bf16 plain prefill and decode steps (control: no shared expert);
11. training (``training_phase``): B3, B4 and B5 inside their autograd
   Functions at the training runs' shapes, forward and every input's
   grad against autograd of the plain versions (``GRAD_FN_TOL``), each
   explicit backward's time beside its forward kernel's and SDPA's
   forward + backward; zamba2-1.2b at full width cut to ``GRAD_LAYERS``
   layers, where every param leaf must get a finite gradient through the
   Functions within ``GRAD_TOL`` of the f32 plain path (the bf16 plain
   path beside it), ``remat`` on equal to off, and a control: the kernels
   without their Functions leave leaves with no gradient; then three
   runs through ``launch.train`` with every count zeroed just before and
   read just after: (a) ``main`` at ``--arch 100m`` (f32, 40 steps, a
   checkpoint that must restore bitwise into the params it was written
   from; the loss must fall), (b) zamba2-1.2b at its full config and (c)
   rwkv6-7b at full width and ``RWKV_TRAIN_LAYERS`` layers, both bf16
   with ``remat``, 3 steps each; each run's launches must equal its
   layers of each kind x steps (x 2 with ``remat``), and prints its step
   seconds, tokens/s, the device's busy share of a profiled step and its
   peak memory;
12. sharding (``sharding_phase``): ``launch.make_host_mesh()`` on this
   card (``nccl``, a ``(1, 1)`` ``("data", "model")`` ``DeviceMesh``;
   no fallback); every config's param specs in both modes on the
   production meshes (``SPEC_MESHES``, as names and sizes) held to the
   JAX reference's digests (``GOLDEN_SPECS``, pinned by
   ``tests/test_torch_sharding.py``), with a control (one leaf's spec
   replicated) that must miss; zamba2-1.2b at its full config, its
   params put on the mesh by ``distribute_tensor`` under its
   ``"serve"`` placements and its caches under ``cache_specs`` (each
   ``to_local()`` bitwise the source; the copies and the extra peak
   memory printed), a 32-token prefill and 3 decode steps at batch 2 on
   the local tensors with ``partitioning`` off, on, on, off, bitwise
   equal,
   each run's B2-B4 launches (zeroed just before, read just after)
   equal to the layers x calls; the constraints on a ``DTensor`` of the
   mesh;
13. one line of seconds a phase and the total, one JSON line of kernel
   measurements, one of path numbers, then ``{"ok": true, ...}``.

Any mismatch or fault exits non-zero; no phase's failure is caught.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: The simulator path's monolithic runs take the first ``SIM_EVENTS``
#: events of the quickstart trace (every engine is prefix-consistent, so
#: they are the first outcomes of the full run); its chunked runs take
#: the whole trace in chunks of ``CHUNK_EVENTS`` (3,000, 3,000, 3,000 and
#: 2,215: for any power-of-two block from 16 to 512 events each chunk
#: leaves an eager remainder).
SIM_EVENTS = 4000
CHUNK_EVENTS = 3000
#: The CPU ``gather`` run that the card's head runs are held to takes
#: their first ``CPU_EVENTS`` events (prefix-consistent, as above), not
#: the whole head, to keep the script inside its time budget.
CPU_EVENTS = 1000
#: The JAX reference's per-event results on that head (blake2s of the
#: int32 bytes of ``node``/``outcome``; outcome counts hit/miss/drop) and
#: the whole trace's fingerprint.
GOLDEN_TRACE = "5489dd9ada1ec219cdf06755e781cf07e50c73ebc93a9b57c823baf3b67c8a79"
GOLDEN = {
    "kiss4096": dict(
        node="fbe8618d68ab21d81e236baa7571d2ea3787cd0e9352e48ae54334cc4e09e8cf",
        outcome="d76ef4f75c6c534bd74eba137570561a0fe6332c2a3e0de970a22672e0bb78d3",
        counts=[2354, 1030, 616]),
    "het16_size_aware": dict(
        node="9cfee99709afcaf0110027e0ce2588a70caa239f8f363500feab6dc6df610783",
        outcome="f25d51137f32672d5f779316014d605b3ba5cdf337ad8e592971fcdd6201281d",
        counts=[3785, 180, 35]),
}
#: The JAX reference's results on the whole trace (``chunk_events=3000``;
#: its chunked runs equal its monolithic ones), for the chunked runs.
GOLDEN_FULL = {
    "kiss4096": dict(
        node="38e86a450f4b173d799627da98a5cb91d1f0ec4859c179c575f209f1c4b8f94b",
        outcome="f505a59d7e0ff83363854ecfddaac3cfb578e3b5147c53f1dbb60ebd1589cbbd",
        counts=[6783, 2988, 1444]),
    "het16_size_aware": dict(
        node="5343eaef53911129c43daf12ec35c7272bf9863fe038ddd8286687984cb0f49f",
        outcome="9f0f67d28a2c7524544c18be9b92b718f71b3e7ec8900d763eb29b1057b19016",
        counts=[10920, 222, 73]),
}
#: The failure phase: ``het16_cluster("size_aware")`` over the
#: ``SIM_EVENTS`` head with nodes 0 and 2 down over these fractions of
#: the head's last event time (``tests/test_replay.py``'s windows), run
#: monolithic and in chunks of ``FAIL_CHUNK``; the JAX reference's
#: digests, residents invalidated per node and ``downtime_pct``.
FAIL_WINDOWS = ((0.2, 0.5, 0), (0.4, 0.8, 2))
FAIL_CHUNK = 1000
GOLDEN_FAIL = dict(
    node="b4b4be3228a94f47c261a1cc7c9606663f85cd3eba8afab41154ff2d3873c8b1",
    outcome="5b03c2a4db60c7cb6efda850c3b4b55d93362f3c342deb49987733501429dcc2",
    counts=[3480, 462, 58],
    invalidated=[9, 0, 13] + [0] * 13,
    downtime_pct=4.3140625)

#: The autoscale phase: the whole trace through ``autoscale_scenarios``
#: (kiss4096 re-splitting every ``ASC_EPOCH`` events; het16 with the
#: failure windows over the whole trace, re-splitting and spawning or
#: retiring nodes from 12 of 16), in every mode; the JAX reference's
#: results (``autoscale_digests``: digests of ``node``/``outcome``, of
#: ``fracs``' f32 bytes and of ``active``, ``invalidated`` and the
#: summary's epoch and membership keys), pinned by
#: ``tests/test_torch_autoscale.py``.
ASC_EPOCH = 512
GOLDEN_ASC = {
    "kiss4096": dict(
        node="38e86a450f4b173d799627da98a5cb91d1f0ec4859c179c575f209f1c4b8f94b",
        outcome="4c8f601c1e50bf4a7151e8e347fea7c85e087c6b4e6d68584eb0ca7f9cb542d7",
        counts=[6707, 3130, 1378],
        fracs="13e635bfaa2d2dc75025f7f7d92d902f404140d1fde056fca1f43d7a69334d66",
        active="818fc7fc08c2f8b4ba07ee082e7c38e9ccc9efb49e408b93fc77a13bd9a2764b",
        invalidated=[0], n_epochs=22, n_invalidated=0, n_active_final=1,
        n_active_min=1, frac_min=0.732809841632843,
        frac_max=0.81744384765625),
    "het16_nodes_failures": dict(
        node="ae21d8c97dc0a7ca2927c033769cbfc8def249e41dcb3e38c6e9a5c7236ca82a",
        outcome="6443aa5109cdfd2746fb3b10033b71673277a92a353c192120495ec5c3208a22",
        counts=[9670, 1350, 195],
        fracs="c29703b7dde1768d91e9c33adabfc53e820bf0026aafd92d94c56871cbf87e58",
        active="b2af5b80036184f3197cab49ef8a06130d977416ac4a95a35d1ac50d8e0d08ca",
        invalidated=[32, 43, 41, 0, 0, 19, 0, 0, 17, 0, 0, 0, 20, 18, 10, 0],
        n_epochs=22, n_invalidated=200, n_active_final=9, n_active_min=8,
        frac_min=0.5, frac_max=0.8999999761581421),
}

#: The telemetry and chain phase, with the repo's own benchmarks'
#: settings (``benchmarks/telemetry.py``, ``benchmarks/chains.py``):
#: ``telemetry_scenarios`` over the whole quickstart trace (the 4-node
#: size-aware cluster with windows of ``TEL_WINDOW`` events, monolithic
#: and in chunks of ``TEL_CHUNK``, which does not divide the window; and
#: ``GOLDEN_ASC``'s het16 with node scaling and the outages, with windows
#: of ``CHAIN_WINDOW`` events: retirements' invalidations), and
#: ``chain_scenarios`` over the chain benchmark's trace
#: (``repro_torch.workloads.benchmark_chained_trace``: 7,076 events in
#: 1,769 chains) on two 2 GB nodes with node 1 down over ``CHAIN_OUTAGE``,
#: ``Chains(slack=4.0)``, windows of ``CHAIN_WINDOW`` events,
#: ``slack_aware`` also in chunks of ``CHAIN_CHUNK``.  ``GOLDEN_TEL`` and
#: ``GOLDEN_CHAIN`` are the JAX reference's results (``tel_digests``),
#: pinned by ``tests/test_torch_telemetry.py`` and
#: ``tests/test_torch_chains.py``.
TEL_WINDOW = 2048
TEL_CHUNK = 3000
CHAIN_WINDOW = 512
CHAIN_CHUNK = 1000
CHAIN_OUTAGE = ((300.0, 1200.0, 1),)
GOLDEN_CHAINED_TRACE = "52ea8a6858ec5f2a27a909a4337b8574e1f86e8cdb5d311a5b0f28d776966cc3"
GOLDEN_TEL = {
    "size_aware_4n": dict(
        node="a4903e520896fe342f0fa2658248c5200cd6eaa1bb42b590ec481a7a0af98321",
        outcome="7dd20cf3d0c0e27644b65d20f54b34a665387c1baf0db0b649c051feffab8ee9",
        counts=[8478, 1379, 1358],
        summary="037bb249bc0ac010ddd9db6a47949f295b140914ab92dd62669b0fbc97bf23e6",
        n_windows=6,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=0,
        tel_counts="71eabf89a90b7b0037df2dcc243453fc5ad45251c87df022293b0a3ac3c38a0d",
        tel_free_mb="e9bf365e91818f8985ffee0b88176eb0f03da4d21c2f2e4579e0892828ec5a6f",
        tel_occupancy="e5f19c7eaf2d4d94091684ac1c9bdfe2c97a303d2f710d32beac9bc5224ea6f6",
        tel_invalidated="f401874fee3bc5e1fcbabfba108e5b9a9950d45810190098aae7734e91a1240f",
        tel_nodes_up="6b17386508f31d7f63c3fda5327ba4093b2181203fdde04bdabd51610481167e",
        tel_nodes_active="6b17386508f31d7f63c3fda5327ba4093b2181203fdde04bdabd51610481167e",
        tel_chain_miss="f401874fee3bc5e1fcbabfba108e5b9a9950d45810190098aae7734e91a1240f",
        tel_t_start="702090dc1e3aa1330cdb747efb4adedcd4cfe3484ff5d9ea0de6cb18c48df0ba",
        tel_t_end="3dfc2671a0d294f9af392277fa032c66af556392c5da94fac941905e9251a6ca",
        tel_event_start="7d3e6906e99ac64d33eb37b0b9e8383bdeeeb0b0397484ba1f7c0627f3c28561"),
    "het16_nodes_failures": dict(
        node="ae21d8c97dc0a7ca2927c033769cbfc8def249e41dcb3e38c6e9a5c7236ca82a",
        outcome="6443aa5109cdfd2746fb3b10033b71673277a92a353c192120495ec5c3208a22",
        counts=[9670, 1350, 195],
        summary="96325d6eb8fa3d1d469581005fbc15501781206f63a62a9bb59be4789d7e0134",
        n_windows=22,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=200,
        tel_counts="c78fee5a5100800761b3a788042904dc35aaba3e248e951e068b9f811ce48e08",
        tel_free_mb="4c16977bf55466ba9d9cc2ab3c88a64030d4253d15743e822e123365cb758cc2",
        tel_occupancy="3d6d0477fb38b382e57ae8d981c45c986c8f483114f58819842aee40f50d01af",
        tel_invalidated="a07d53ae772f7b1dacfa39e54d049b7c38438fed00e9aee3b06352e92a19e3c0",
        tel_nodes_up="447ac91c9086babb09c0e9d66c538aac59cabcee5eb58796754a7ba46036c177",
        tel_nodes_active="c9d621a45116001a9bd23c5413e2c40960b1e762e8a28905cb710e238a290f38",
        tel_chain_miss="57940312e598617b2d464a34a17cb58abf7a11e1146866224f22ce6dcb3222e0",
        tel_t_start="f70ad8169e72bba0d63e3ea2bc3be7aebaa51c513f657c0f51e422b8c1d2255f",
        tel_t_end="e80320388037508de9dbff05a3f70f97c4adb6674c66494ddc811769843df4f7",
        tel_event_start="6e4a1777f2f713bf756bf4c73df87a832a60720cb084ec4ef15cef03d2d72b00"),
}
GOLDEN_CHAIN = {
    "slack_aware": dict(
        node="9066f9db985b5e589f61816f416060b634b67ed46c3c5210fe4948e022ce9c37",
        outcome="439993382334c877a41f3fb6a863e326dccdb94733e0899d1e8ee19644476c82",
        counts=[1644, 3916, 1516],
        summary="e642677ab38ea6a22c74e3ab254fdb25244379643a3202739cfc98225441775b",
        n_windows=14,
        n_chains=1769,
        deadline_miss_pct=83.38044092707744,
        n_invalidated=37,
        tel_counts="a3f36ea66bb62a9d42f63175223a337c898e3ae6bfe49cd7687a50760d61e29e",
        tel_free_mb="eefc8040fbd26fb0c1a0c7a1382ba8eb7245df30cb3de9b6a41353f6dc7950ff",
        tel_occupancy="4bac05225933eba8f1fa35a37f74f258b45ee68f88d5152f9242c210f3593b29",
        tel_invalidated="4a55af63a2d1a325c7332872eb376af3bd3a1c18a47d45107edd9bd7eb15af9b",
        tel_nodes_up="ae1e81bd0870d5021109feabd41f39bba8a75d7e8859457e28689023a4b4261d",
        tel_nodes_active="63abd08b5eeed6b7ae78e7d2d381a287803e80cdcc2acbd3dc3a5412619b0aa5",
        tel_chain_miss="49306e105646dfc0f41e80262e4bf44309c4070615473d82746f4e8941bdb0b1",
        tel_t_start="69d5a1e6b23adb3c045d91092695d113084ca1eca5e2ab8873c618fb63c257a2",
        tel_t_end="dcacc635fa80656e3c48ffbcf0d91855f200c3ca6e49cb5ab3e2ec1b3cf260a1",
        tel_event_start="1a076629ba0390e912b932e539688db6668b4cb6a15b2a22926f8e2af2249f30",
        chain_latency="76e0de028d1cb7fd147942faf07e461a1f16bf8df4dd76b13176447997061bc9",
        chain_dropped="e00219f7dc98668c66fd662b55fe0f738cf486af9b98cb1fd1c41605d4b4d249",
        chain_done="bef20a5affcee1a205879f06e306ae6d76ad185358ff618f784ae43780f79eca",
        chain_missed="b0a5865773664872d520510e9229486c12eab22e4b31eb3f0e045d73deed222f",
        chain_deadline="700e20ba61e2bbc8ea2069b0a723f95548702d92b0cb54e85f0b6af4302d5dd8"),
    "size_aware": dict(
        node="20e7669c504f168109aae9bcd35a3e9681d5cf34ca07030167c5220a0dbeb342",
        outcome="f7143fa1823a1f8e74bd677569eab3b9fabe136c9ee987eb54e61e6c7d475f47",
        counts=[1439, 5264, 373],
        summary="9913a1ee843f20e26a86fec0b905c92ea291d65c8f4ca0e8ee04161d1035dfda",
        n_windows=14,
        n_chains=1769,
        deadline_miss_pct=85.30243075183719,
        n_invalidated=37,
        tel_counts="85c5b684acb8d855170eba857ca14849799570fd3d71b53e3efbe164524e274f",
        tel_free_mb="c026d3ef62301551aa400592ecff86687a1709d81a73c874f558f0082a3df309",
        tel_occupancy="164dfd4bd3e8121f37f73b0762a5e2d028b4de49bad3156098609d579a79cc40",
        tel_invalidated="4a55af63a2d1a325c7332872eb376af3bd3a1c18a47d45107edd9bd7eb15af9b",
        tel_nodes_up="ae1e81bd0870d5021109feabd41f39bba8a75d7e8859457e28689023a4b4261d",
        tel_nodes_active="63abd08b5eeed6b7ae78e7d2d381a287803e80cdcc2acbd3dc3a5412619b0aa5",
        tel_chain_miss="4f7772217ba7d0a9c5fd164b99bf117ecaf13cc53e357de54ee304bf3f7aaed3",
        tel_t_start="69d5a1e6b23adb3c045d91092695d113084ca1eca5e2ab8873c618fb63c257a2",
        tel_t_end="dcacc635fa80656e3c48ffbcf0d91855f200c3ca6e49cb5ab3e2ec1b3cf260a1",
        tel_event_start="1a076629ba0390e912b932e539688db6668b4cb6a15b2a22926f8e2af2249f30",
        chain_latency="c1f203950b35e07ec636155df1c03f868bb348f43e0cd2951689a74455fb65b9",
        chain_dropped="d03f2e03812ecde81b42b1196934e9f4e8d51724d853bfeb496daf228fc4ae7b",
        chain_done="bef20a5affcee1a205879f06e306ae6d76ad185358ff618f784ae43780f79eca",
        chain_missed="30e1ff716d367ee7129df2b640e745c8bf23cc0b8cf53b82575a0a9a497a39c6",
        chain_deadline="700e20ba61e2bbc8ea2069b0a723f95548702d92b0cb54e85f0b6af4302d5dd8"),
}

#: The vertical-scaling phase, with ``benchmarks/vertical.py``'s own
#: settings: its cluster (``RZ_NODE_MB``, ``RZ_SLOTS`` slots a pool,
#: ``size_aware``) and its four lanes (``vertical_lanes``: KiSS without
#: resize, KiSS with the ``static`` resize policy, unified nodes with
#: ``Resize("fair_share", RZ_MIN_MB)`` and the hybrid, KiSS split with
#: it), on the quickstart trace in every run shape (``vertical_runs``)
#: and the hybrid over the whole of the benchmark's Azure replay trace
#: (``repro_torch.workloads.benchmark_replay_trace``: 192,047 events) in
#: chunks of ``RZ_REPLAY_CHUNK``, as the benchmark runs it.
#: ``GOLDEN_RZ`` holds the JAX reference's results (``rz_digests``:
#: ``tel_digests`` and the three ``Result.vertical`` arrays), pinned by
#: ``tests/test_torch_vertical.py``.
RZ_NODE_MB = (1024.0, 1024.0, 2048.0, 2048.0)
RZ_SLOTS = 128
RZ_MIN_MB = 32.0
RZ_REPLAY_CHUNK = 65536
GOLDEN_REPLAY_TRACE = "6670a1cc87f72476f5e402d0e3185806730a1895429e1da45eb8a20df38363cd"
GOLDEN_RZ = {
    "kiss_static": dict(
        node="5953eb1acc6f379c262cc13043a69b0d997354239908b42d359499b9e89fe7a4",
        outcome="0a19a53dd66d2cd8e83a5789ede9e33650a08cbdc8f904fb158fc10fc19367c2",
        counts=[6992, 2613, 1610],
        summary="dd0e1fa32ea6f4a6588158bf83d1879583129b2cce45607c09b0165068bbfe90",
        n_windows=0,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=0,
        utilization_ratio=0.0,
        bottleneck_events=0),
    "kiss_rz_static": dict(
        node="5953eb1acc6f379c262cc13043a69b0d997354239908b42d359499b9e89fe7a4",
        outcome="0a19a53dd66d2cd8e83a5789ede9e33650a08cbdc8f904fb158fc10fc19367c2",
        counts=[6992, 2613, 1610],
        summary="c514aa3452d78301c86d1c140da104610d180d759984e1cef8c081eaa908beae",
        n_windows=0,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=0,
        utilization_ratio=0.7480897445136762,
        bottleneck_events=0,
        vert_acc_used_mb="8d69a4efb3f893782607f893a7eae791cc9743ece213cbf7c7ca1546dc20c7e3",
        vert_acc_alloc_mb="f3f9c110bffab8ae892f13aa5d5038d763898f59d98174fb7f3b754188f386ad",
        vert_bottlenecks="ae09db7cd54f42b490ef09b6bc541af688e4959bb8c53f359a6f56e38ab454a3"),
    "vertical_dynamic": dict(
        node="575b8c0dffa9b420da5ecd75eb304018deeafb5024a7095168766c92f9d6746d",
        outcome="4aa6c40a7fceab83f53f9b2675ca6d04d511f6ff032c828ee93512adef747804",
        counts=[6530, 3788, 897],
        summary="9044f0ce3db88443021f49fcdfdc43c11d63853f24912f78a68cd7f4e12b8239",
        n_windows=0,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=0,
        utilization_ratio=0.8234248685058966,
        bottleneck_events=5184,
        vert_acc_used_mb="b823a0b4046e3670878f7a711cf798ba5be989fd36274d09eb35916ff7226cf7",
        vert_acc_alloc_mb="0843dbb2795adb1ad8b35c92c4f59568133f42c3736317070a96bd99495703b2",
        vert_bottlenecks="8ecb1989f5f18e0c9ac21fe1a0f999773fd7bb8f8e4a90c28ce7419dd7f8500e"),
    "hybrid": dict(
        node="5953eb1acc6f379c262cc13043a69b0d997354239908b42d359499b9e89fe7a4",
        outcome="2ccf9adb669057aa2b986d21c63f0e88bc1078fea56f41c53ceaf0fa68c705a1",
        counts=[7929, 1676, 1610],
        summary="becc1912eb8f83c9ad4cdceaff98bd6889325e5414b4ec825f78a98b40a5e8da",
        n_windows=0,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=0,
        utilization_ratio=0.8129327076732259,
        bottleneck_events=4341,
        vert_acc_used_mb="8d69a4efb3f893782607f893a7eae791cc9743ece213cbf7c7ca1546dc20c7e3",
        vert_acc_alloc_mb="f1b78c8b6b58bf2a189c251cc2479372c9245b6fc48b0738658b9b36a89c00cc",
        vert_bottlenecks="df15fd4041d2b0ff89f28fd437d216c9c7bad1cff786579139c3c0b3dea43b92"),
    "hybrid_failures": dict(
        node="36d6911a5644ec8c629259aae6f3194b5f36edc85e4d430a87028a38dbaee790",
        outcome="45bbf2a1b9a3ac9ee0ed86bb413a6dd97bf04e50d10bed84b3f8d27604a2feb0",
        counts=[6241, 3354, 1620],
        summary="be5d3cac3ce2c61d3946ed14c924be456e1e07db4b895967fb04ed6d278812e7",
        n_windows=0,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=60,
        utilization_ratio=0.8108916088392697,
        bottleneck_events=4190,
        vert_acc_used_mb="3e4d1743e6deeb8976cb509085a4692a4a84430bc251e2ebdc9b2582d59f8cf0",
        vert_acc_alloc_mb="bc70b37ecd10a1c2c813831410f0b5c92414928a0b5c1807dd8f3dceedab3e82",
        vert_bottlenecks="4e1c98633a7368b213d4ae716fd04860e70b545a484b5dee7c4e6c26d02aef75"),
    "hybrid_autoscale": dict(
        node="0ce5515958e9e89d17b9160e5cae6faea726e98d56b4128a7eade07083c281f5",
        outcome="fc99c62dda8f3665cba3aa7a2484dbcd59c6c804d2efa8fbe74933bb9792eb5b",
        counts=[8713, 1211, 1291],
        summary="3c9b7d698fe0690061422f9a423af77fd7a2c5554f98b29a05c5fe138cee5225",
        n_windows=0,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=0,
        utilization_ratio=0.8394169812343093,
        bottleneck_events=5639,
        vert_acc_used_mb="3dfc19544ecefb9766dcf9b7f61c2955efc6a1abaa4c9af01319a3923841209a",
        vert_acc_alloc_mb="6926a3d5e996e8a63e3c63841336c170b7f0bce1f20a1d3c344d2c6cd2f854d4",
        vert_bottlenecks="650ef4f629c7bbd81d3297360f1b4775983ff9b52d954ba1c97995d0c3f02684"),
    "hybrid_telemetry": dict(
        node="5953eb1acc6f379c262cc13043a69b0d997354239908b42d359499b9e89fe7a4",
        outcome="2ccf9adb669057aa2b986d21c63f0e88bc1078fea56f41c53ceaf0fa68c705a1",
        counts=[7929, 1676, 1610],
        summary="57825b6e25f29a9b1529fb4a53aa1257e319768d8be4d86c713b3a682eaf51f4",
        n_windows=6,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=0,
        tel_counts="d20fb254941422b3344da71a2c997afefc1eb4c52d94ebdb516417d70cf93bf3",
        tel_free_mb="4b39c32c7617f2cc555f55d4dc57ef86c2d124abd06a47ad9e1f8a1c38fc1fdd",
        tel_occupancy="b03cc17b183dcb45a20f598464f0683e8b6b1aa24d5e402d7f982777433e0d68",
        tel_invalidated="f401874fee3bc5e1fcbabfba108e5b9a9950d45810190098aae7734e91a1240f",
        tel_nodes_up="6b17386508f31d7f63c3fda5327ba4093b2181203fdde04bdabd51610481167e",
        tel_nodes_active="6b17386508f31d7f63c3fda5327ba4093b2181203fdde04bdabd51610481167e",
        tel_chain_miss="f401874fee3bc5e1fcbabfba108e5b9a9950d45810190098aae7734e91a1240f",
        tel_t_start="702090dc1e3aa1330cdb747efb4adedcd4cfe3484ff5d9ea0de6cb18c48df0ba",
        tel_t_end="3dfc2671a0d294f9af392277fa032c66af556392c5da94fac941905e9251a6ca",
        tel_event_start="7d3e6906e99ac64d33eb37b0b9e8383bdeeeb0b0397484ba1f7c0627f3c28561",
        utilization_ratio=0.8129327076732259,
        bottleneck_events=4341,
        vert_acc_used_mb="8d69a4efb3f893782607f893a7eae791cc9743ece213cbf7c7ca1546dc20c7e3",
        vert_acc_alloc_mb="f1b78c8b6b58bf2a189c251cc2479372c9245b6fc48b0738658b9b36a89c00cc",
        vert_bottlenecks="df15fd4041d2b0ff89f28fd437d216c9c7bad1cff786579139c3c0b3dea43b92"),
    "hybrid_replay": dict(
        node="02ecc1e4a45cf7ed648fce137c65e8daa23ef371a97673132d1d670f1ad6fc72",
        outcome="4a4750c9d771beb98d415679e7a3cd503e5214fd4c27f9d6a6bbc84dc48a206f",
        counts=[108297, 27527, 56223],
        summary="8e27b045bb5943b921bc88301c0d3b1c05b930f143a44ec6b7436fee73ac2bd3",
        n_windows=0,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=0,
        utilization_ratio=0.8394002345842548,
        bottleneck_events=68845,
        vert_acc_used_mb="dfda2f3c85440e97a8600e3fbb5b7982d2cab59f96700eeb31e31b5e79b161b1",
        vert_acc_alloc_mb="e63792341a861a7cb9475b5553440dd132d69a999f0f135eef2eda3d0a3762d5",
        vert_bottlenecks="b12776b0bb151981578e6fd06a0df9cf052896d7c1568e78337d32eb4252221f"),
    "vertical_dynamic_replay": dict(
        node="e8a406e82e468257192a56313f0d650e5558eae76b574afba8f6fcdd5bd0ddd8",
        outcome="c616506c31e87aa09f52c24e680590aa4615b920389a6425e26dae3c6358689e",
        counts=[54440, 61593, 76014],
        summary="21342eee33946a538c62ee5f5261ab47d0ed6038225e91c64167089bb8fce2eb",
        n_windows=0,
        n_chains=0,
        deadline_miss_pct=0.0,
        n_invalidated=0,
        utilization_ratio=0.8059465394327183,
        bottleneck_events=30131,
        vert_acc_used_mb="6e05be51bd7dc32c0c69827f6d1820608ab7c9dc8bdfe26abbc3156b53cefc41",
        vert_acc_alloc_mb="b01b9818c5ff40f790043e385d3a6e8191f04f054626aae3e32295e965d0c76b",
        vert_bottlenecks="aba2617f6971875e87bccb5e6729de199416b5fa0c864a170254ecca62c32d07"),
}

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core op/s,
#: dense bf16 tensor-core op/s.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
BF16_OPS_S = 989e12

#: path (kiss4096), path (het16), ragged, the vertical phase's cluster,
#: the sweep phase's widest groups: the edge grid's 40 static lanes
#: (80 rows of 1024 slots) and the routing grid's six het16 lanes (192
#: rows of 256), and the oracle phase's bursty grid (three one-node
#: lanes, 6 rows of 1024)
KERNEL_SHAPES = ((2, 1024), (32, 256), (3, 1000), (8, 128), (80, 1024),
                 (192, 256), (6, 1024))
#: The one ``__global__`` kernel each B1 launch runs.
POOL_KERNELS = ["evict_place_kernel"]


class SmokeError(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def digest(a, dtype=np.int32) -> str:
    return hashlib.blake2s(
        np.ascontiguousarray(a, dtype).tobytes()).hexdigest()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi reported no card")
    return out[0].strip()


def tie_batch(rng, p: int, s: int):
    """Quantized tie-heavy evict-and-place inputs (priorities in {0..3},
    distinct seqs, whole-MB sizes); row 0 is all busy, row 1 (if any)
    has a deficit <= 0, and every idle slot of row 2 (if any) has the
    priority -0.0 or +0.0, at random, so that the row is ordered by seq
    alone across the two zeros."""
    pri = rng.integers(0, 4, (p, s)).astype(np.float32)
    if p > 2:
        pri[2] = np.where(rng.random(s) < 0.5, -0.0, 0.0)
    seq = rng.permutation(np.arange(1.0, p * s + 1, dtype=np.float32)
                          ).reshape(p, s)
    size = rng.integers(1, 400, (p, s)).astype(np.float32)
    valid = rng.random((p, s)) < 0.9
    idle = valid & (rng.random((p, s)) < 0.7)
    idle[0] = False
    pri = np.where(idle, pri, np.inf).astype(np.float32)
    deficit = rng.integers(0, 40 * s, (p,)).astype(np.float32)
    if p > 1:
        deficit[1] = -float(rng.integers(0, 40))
    return pri, seq, size, idle, valid, deficit


def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters``
    calls queued behind a ~50 ms spin kernel, so the host's launch cost
    (the Python wrapper, ~tens of us a call) stays off the clock."""
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_s(events) -> float:
    """Summed device time, in seconds, of the kernels and copies in a
    CPU + CUDA profile's ``key_averages()``: the device rows only, as
    torch's own table sums them.  A CPU op's row repeats, as its self
    device time, the kernels it launched, so a sum over every row counts
    each kernel twice."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e6


def call_ms(fn, iters: int) -> float:
    """Mean milliseconds per call back to back, host cost included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def kernel_ms(fn, names, iters: int = 20) -> dict:
    """Device milliseconds per call of each ``__global__`` kernel whose
    name contains one of ``names``, from ``torch.profiler`` over ``iters``
    calls: the kernels' own run time, without the gaps between launches
    that the CUDA-event time includes.  Each must run once a call.  Fails
    when a name is not in the profile or ran more often than the calls,
    so a renamed kernel, a second launch or a call that took another path
    cannot drop out of the measurements unseen."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for e in prof.key_averages():
            for n in names:
                if n in e.key:
                    total[n] = total.get(n, 0.0) + getattr(
                        e, "self_device_time_total", 0.0)
                    count[n] = count.get(n, 0) + e.count
        check(all(c <= iters for c in count.values()),
              f"kernels {count} over {iters} calls: want each once a call")
        if len(count) == len(names):
            # the mean over the launches recorded: the profiler may lose
            # one launch's record, and has never added one
            return {n: total[n] / 1e3 / count[n] for n in names}
        # a session has come back without any kernel record (only the
        # launch calls), as the first of a process and once mid-run:
        # measure again, four sessions in all, before failing
    check(False, f"kernels {[n for n in names if n not in count]} not in "
          f"the profile (saw {sorted(e.key for e in prof.key_averages())})")


def evict_place_bound_ms(p: int, s: int) -> tuple[float, str]:
    """Least time for one evict-and-place at [p, s] on an H100, the
    larger of: the bytes (pri/seq/size f32 and idle/valid 1 B in, evict
    1 B out, per slot; deficit in and freed/ins/avail/empty out, per
    row) over HBM; and the f32 operations the function needs, whatever
    method computes it, over the f32 peak.  The function is a sort of
    each row's slots by (pri, seq) (s * ceil(log2 s) compares of two
    operations each), a prefix sum and its compare with the deficit,
    the freed and available sums and the first-empty search (one
    operation a slot each).  The kernel's own all-pairs count does
    4 * p * s * s operations instead, which the bound does not charge."""
    nbytes = p * s * (4 + 4 + 4 + 1 + 1 + 1) + p * (4 + 4 + 4 + 4 + 1)
    ops = p * (2 * s * max(1, (s - 1).bit_length()) + 5 * s)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev) -> dict:
    from repro_torch.kernels.pool_step import (evict_place_cuda,
                                               evict_place_plain)
    rows = []
    for p, s in KERNEL_SHAPES:
        args = tuple(torch.tensor(a, device=dev) for a in
                     tie_batch(np.random.default_rng(p * s), p, s))
        got = evict_place_cuda(*args)
        want = evict_place_plain(*args)
        torch.cuda.synchronize()
        err = 0.0
        for name, g, w in zip(("evict", "freed", "ins", "avail", "empty"),
                              got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"evict_place [{p},{s}] {name}: dtype/shape differ")
            check(torch.equal(g, w),
                  f"evict_place [{p},{s}] {name}: kernel != plain")
            err = max(err, float((g.double() - w.double()).abs().max()))
        ms = device_ms(lambda: evict_place_cuda(*args), 100)
        call = call_ms(lambda: evict_place_cuda(*args), 300)
        plain_ms = device_ms(lambda: evict_place_plain(*args), 20)
        bound_ms, bound_by = evict_place_bound_ms(p, s)
        kern = kernel_ms(lambda: evict_place_cuda(*args), POOL_KERNELS)
        rows.append(dict(shape=[p, s], max_abs_err=err, ms=ms,
                         call_ms=call, kernel_ms=kern, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"kernel pool_step.evict_place [{p},{s}]: bitwise == plain; "
              f"device {ms * 1e3:.2f} us/launch ({call * 1e3:.2f} us a "
              f"call back to back; the kernel itself {fmt_us(kern)}), "
              f"plain {plain_ms * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.4f} us ({bound_by})", flush=True)
    return {"rows": rows}


#: Attention tolerance, absolute and relative, the JAX reference's own
#: ``TOL`` (tests/test_kernels.py:14).
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
#: The ``__global__`` kernels each wrapper launches, by dtype: bf16 runs
#: on the tensor cores (``wgmma`` for B3, ``mma.sync`` for B2), f32 on the
#: CUDA cores; B2's combine kernel follows either split kernel.
FLASH_KERNELS = {torch.bfloat16: ["flash_wgmma_kernel"],
                 torch.float32: ["flash_fma_kernel"]}
DECODE_KERNELS = {
    torch.bfloat16: ["decode_mma_kernel", "decode_combine_kernel"],
    torch.float32: ["decode_fma_kernel", "decode_combine_kernel"]}

#: name: (B, Sq, Skv, H, KV, D, causal, window, q_offset).  "path-*" is
#: the serving path's prefill (32 tokens, max_batch 2); the long shapes a
#: whole 4,096-token window.
FLASH_SHAPES = {
    "path-starcoder2": (2, 32, 32, 24, 2, 128, True, 4096, 0),
    "path-glm4": (2, 32, 32, 32, 2, 128, True, None, 0),
    # zamba2-1.2b's shared block: MHA, 32 heads of 64 (G = 1)
    "path-zamba2": (2, 32, 32, 32, 32, 64, True, None, 0),
    "long-h24-w4096": (2, 4096, 4096, 24, 2, 128, True, 4096, 0),
    "long-h24-w1024": (2, 4096, 4096, 24, 2, 128, True, 1024, 0),
    "long-h32-w4096": (2, 4096, 4096, 32, 2, 128, True, 4096, 0),
    "long-h32-w1024": (2, 4096, 4096, 32, 2, 128, True, 1024, 0),
    "ragged-offset": (2, 333, 1000, 24, 2, 128, True, 200, 700),
    "ragged-d64": (3, 77, 77, 8, 2, 64, True, None, 0),
    # kimi-k2-1t-a32b's attention (H = 64 over KV = 8, D = 112) at a
    # 32-token prefill
    "kimi-d112": (2, 32, 32, 64, 8, 112, True, None, 0),
    # granite-moe-1b-a400m (H = 16 over KV = 8, D = 64) and qwen2-vl-7b
    # (a GQA group of 7) at the serving prefill; whisper-medium's encoder
    # over its 1,500 frames and its cross-attention at the prefill (32
    # queries) and at each decode step (1), all non-causal, against a
    # ragged last kv tile
    "path-granite-moe": (2, 32, 32, 16, 8, 64, True, None, 0),
    "path-qwen2vl": (2, 32, 32, 28, 4, 128, True, None, 0),
    "whisper-enc": (2, 1500, 1500, 16, 16, 64, False, None, 0),
    "whisper-x32": (2, 32, 1500, 16, 16, 64, False, None, 0),
    "whisper-x1": (2, 1, 1500, 16, 16, 64, False, None, 0),
}
#: name: (B, S, H, KV, D, window, fill, cur).  "serving" fills slots
#: 0..cur, as the serving path's cache is after a 32-token prefill and a
#: few decode steps; "ring-holes" holds positions cur-S+1..cur at slot
#: pos % S with every fifth position missing.
DECODE_SHAPES = {
    "path-starcoder2": (2, 4096, 24, 2, 128, 4096, "serving", 35),
    "path-glm4": (2, 4096, 32, 2, 128, None, "serving", 35),
    "path-zamba2": (2, 4096, 32, 32, 64, None, "serving", 35),
    "ring-holes-h24-w4096": (2, 4096, 24, 2, 128, 4096, "ring-holes", 6000),
    "ring-holes-h32-w1024": (2, 4096, 32, 2, 128, 1024, "ring-holes", 6000),
    "ragged-holes": (3, 1000, 24, 2, 128, None, "holes", 999),
    "ragged-d64": (2, 300, 12, 2, 64, 100, "holes", 250),
    "kimi-d112": (2, 4096, 64, 8, 112, None, "serving", 35),
    "path-granite-moe": (2, 4096, 16, 8, 64, None, "serving", 35),
    "path-qwen2vl": (2, 4096, 28, 4, 128, None, "serving", 35),
    # whisper's decoder self-attention: 448 target positions, MHA
    "path-whisper": (2, 448, 16, 16, 64, None, "serving", 35),
}


def close_check(got, want, dtype, what: str, tol=None) -> float:
    """|got - want| <= atol + rtol * |want| everywhere, ``tol`` = (atol,
    rtol), by default ``ATTN_TOL[dtype]`` for both; the max abs error."""
    atol, rtol = tol or (ATTN_TOL[dtype],) * 2
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} elements beyond atol {atol}, rtol "
          f"{rtol} (max abs err {float(err.max()):.3g})")
    return float(err.max())


def flash_bound_ms(b, sq, skv, h, kv, d, causal, window, q_offset,
                   dtype) -> tuple[float, str]:
    """Least time for the flash function on an H100: bytes (q, k, v read
    once, the output written once) over HBM, against the multiply-adds
    this mask needs (4 * D a visible (query, key) pair and head: QK^T and
    PV) over the peak for the dtype (bf16 tensor cores, or f32)."""
    item = torch.tensor([], dtype=dtype).element_size()
    qpos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    nbytes = item * (2 * b * sq * h * d + 2 * b * skv * kv * d)
    ops = 4 * d * pairs * b * h
    rate = BF16_OPS_S if dtype == torch.bfloat16 else F32_OPS_S
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_bound_ms(q, k_cache, slot_pos, cur, window) -> tuple[float, str]:
    """Least time for decode attention on an H100: the bytes this run's
    data needs (slot_pos and cur; q and the output; K and V rows of the
    visible slots only) over HBM, against 4 * D multiply-adds a visible
    slot and query head over the peak for the dtype."""
    b, h, d = q.shape
    kv = k_cache.shape[2]
    item = q.element_size()
    c = cur[:, None]
    vis = (slot_pos >= 0) & (slot_pos <= c)
    if window is not None:
        vis &= slot_pos > c - window
    n_vis = int(vis.sum())
    nbytes = (slot_pos.numel() * 4 + b * 4 + 2 * b * h * d * item
              + n_vis * 2 * kv * d * item)
    ops = 4 * d * h * n_vis
    rate = BF16_OPS_S if q.dtype == torch.bfloat16 else F32_OPS_S
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_case(shape, dtype, dev, seed):
    b, sq, skv, h, kv, d = shape[:6]
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(sh, generator=g, device=dev).to(dtype)
                 for sh in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))


def decode_case(shape, dtype, dev, seed):
    b, s, h, kv, d, window, fill, cur = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(sh, generator=g, device=dev).to(dtype)
               for sh in ((b, h, d), (b, s, kv, d), (b, s, kv, d)))
    slots = torch.arange(s, device=dev, dtype=torch.int32)
    if fill == "serving":
        sp = torch.where(slots <= cur, slots, -1)
    elif fill == "ring-holes":
        pos = cur - s + 1 + slots
        sp = torch.empty_like(slots)
        sp[pos % s] = torch.where(pos % 5 == 2, -1, pos)
    else:
        sp = torch.where(slots % 5 == 2, -1, slots)
    sp = sp[None].expand(b, s).contiguous()
    return q, k, v, sp, torch.full((b,), cur, dtype=torch.int32, device=dev)


def attention_phase(dev) -> dict:
    """B3 and B2 against their plain versions in bf16 and f32 at every
    shape; then, in bf16, timed beside the plain version, one
    ``scaled_dot_product_attention`` call (GQA, a boolean mask where the
    window or the cache's slots bind) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)
    out = {"flash": [], "decode": []}
    for name, shape in FLASH_SHAPES.items():
        b, sq, skv, h, kv, d, causal, window, q_offset = shape
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        errs, f32_kern = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_case(shape, dtype, dev, sq + h)
            got = flash_attention_cuda(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            errs[str(dtype)] = close_check(got, want, dtype,
                                           f"flash {name} {dtype}")
            if dtype == torch.float32:      # the CUDA-core kernel ran
                f32_kern = kernel_ms(
                    lambda: flash_attention_cuda(q, k, v, **kw),
                    FLASH_KERNELS[dtype], 2 if sq >= 1024 else 5)
        iters = 10 if sq >= 1024 else 100
        ms = device_ms(lambda: flash_attention_cuda(q, k, v, **kw), iters)
        call = call_ms(lambda: flash_attention_cuda(q, k, v, **kw), iters)
        plain = device_ms(lambda: flash_attention_plain(q, k, v, **kw),
                          max(iters // 5, 2))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qpos = torch.arange(sq, device=dev)[:, None] + q_offset
        kpos = torch.arange(skv, device=dev)[None, :]
        if q_offset == 0 and sq == skv and (window is None
                                            or window >= skv):
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
        else:
            mask = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
            if window is not None:
                mask = mask & (kpos > qpos - window)

            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_err = float((lib().transpose(1, 2).float()
                         - got.float()).abs().max())
        lib_ms = device_ms(lib, iters)
        bound, bound_by = flash_bound_ms(*shape, torch.bfloat16)
        kern = kernel_ms(lambda: flash_attention_cuda(q, k, v, **kw),
                         FLASH_KERNELS[torch.bfloat16],
                         5 if sq >= 1024 else 20)
        out["flash"].append(dict(
            shape=name, dims=list(shape[:6]), window=window,
            q_offset=q_offset, max_abs_err=errs, ms=ms, call_ms=call,
            kernel_ms=kern, f32_kernel_ms=f32_kern,
            plain_ms=plain, library_ms=lib_ms, library_max_abs_diff=lib_err,
            bound_ms=bound, bound_by=bound_by))
        print(f"kernel flash_attention {name} {list(shape[:6])} w={window}: "
              f"== plain (max abs err f32 {errs['torch.float32']:.2e}, bf16 "
              f"{errs['torch.bfloat16']:.2e}); bf16 device {ms * 1e3:.2f} "
              f"us/launch ({call * 1e3:.2f} us a call back to back; the "
              f"kernel itself {fmt_us(kern)}), plain "
              f"{plain * 1e3:.2f} us, sdpa {lib_ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.3f} us ({bound_by}); f32 on "
              f"{fmt_us(f32_kern)}", flush=True)
    for name, shape in DECODE_SHAPES.items():
        window = shape[5]
        errs, f32_kern = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, sp, cur = decode_case(shape, dtype, dev, shape[1])
            got = decode_attention_cuda(q, k, v, sp, cur, window=window)
            want = decode_attention_plain(q, k, v, sp, cur, window=window)
            torch.cuda.synchronize()
            errs[str(dtype)] = close_check(got, want, dtype,
                                           f"decode {name} {dtype}")
            if dtype == torch.float32:      # the CUDA-core kernel ran
                f32_kern = kernel_ms(
                    lambda: decode_attention_cuda(q, k, v, sp, cur,
                                                  window=window),
                    DECODE_KERNELS[dtype], 5)
        ms = device_ms(lambda: decode_attention_cuda(q, k, v, sp, cur,
                                                     window=window), 200)
        call = call_ms(lambda: decode_attention_cuda(q, k, v, sp, cur,
                                                     window=window), 200)
        plain = device_ms(lambda: decode_attention_plain(
            q, k, v, sp, cur, window=window), 20)
        c = cur[:, None]
        vis = (sp >= 0) & (sp <= c)
        if window is not None:
            vis &= sp > c - window
        mask = vis[:, None, None, :]
        q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)

        def lib():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = float((lib()[:, :, 0].float() - got.float()).abs().max())
        lib_ms = device_ms(lib, 200)
        bound, bound_by = decode_bound_ms(q, k, sp, cur, window)
        kern = kernel_ms(lambda: decode_attention_cuda(q, k, v, sp, cur,
                                                       window=window),
                         DECODE_KERNELS[torch.bfloat16])
        out["decode"].append(dict(
            shape=name, dims=list(shape[:5]), window=window, fill=shape[6],
            visible_slots=int(vis.sum()), max_abs_err=errs, ms=ms,
            call_ms=call, kernel_ms=kern, f32_kernel_ms=f32_kern,
            plain_ms=plain,
            library_ms=lib_ms, library_max_abs_diff=lib_err,
            bound_ms=bound, bound_by=bound_by))
        print(f"kernel decode_attention {name} {list(shape[:5])} "
              f"w={window} ({int(vis.sum())} visible slots): == plain (max "
              f"abs err f32 {errs['torch.float32']:.2e}, bf16 "
              f"{errs['torch.bfloat16']:.2e}); bf16 device {ms * 1e3:.2f} "
              f"us/launch ({call * 1e3:.2f} us a call back to back; the "
              f"kernels themselves {fmt_us(kern)}), plain "
              f"{plain * 1e3:.2f} us, sdpa {lib_ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.3f} us ({bound_by}); f32 on "
              f"{fmt_us(f32_kern)}", flush=True)
    return out


#: Scan tolerances (atol, rtol): in f32 the reference's own bound for its
#: chunked kernel against its sequential oracle (tests/test_kernels.py),
#: in bf16 its ``TOL``.
SCAN_TOL = {torch.float32: (5e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
#: The ``__global__`` kernel each wrapper launches, by dtype: B4 in bf16 on
#: the tensor cores (``mma.sync``), in f32 on the CUDA cores; B5 one
#: kernel for both.
SCAN_KERNELS = {
    "ssm_scan": {torch.bfloat16: ["ssm_scan_mma_kernel"],
                 torch.float32: ["ssm_scan_fma_kernel"]},
    "wkv6": {torch.bfloat16: ["wkv6_kernel"], torch.float32: ["wkv6_kernel"]},
}
#: name: (B, S, H, P, N, h0).  "path-zamba2" is zamba2's serving prefill
#: (32 tokens, max_batch 2, 64 SSM heads of P = N = 64); 1,000 steps is
#: not a multiple of the kernel's 64-step chunk.
SSM_SHAPES = {
    "path-zamba2": (2, 32, 64, 64, 64, False),
    "long-4096": (2, 4096, 64, 64, 64, False),
    "ragged-h0": (2, 1000, 64, 64, 64, True),
}
#: name: (B, S, H, state).  "path-rwkv6-*" are rwkv6's serving prefill
#: and decode step (64 WKV heads of D = 64); 1,000 steps is not a
#: multiple of the kernel's 32-step chunk.
WKV_SHAPES = {
    "path-rwkv6-prefill": (2, 32, 64, False),
    "path-rwkv6-decode": (2, 1, 64, True),
    "long-4096": (2, 4096, 64, False),
    "ragged-state": (2, 1000, 64, True),
}


def ssm_case(shape, dtype, dev, seed):
    """zamba2-like inputs: a = -linspace(1, 16, H) (its ``a_log`` init),
    dt = softplus(z), B and C at 0.3, h0 at 0.2; x, B, C in ``dtype``."""
    b, s, h, p, n, h0 = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*sh):
        return torch.randn(sh, generator=g, device=dev)
    x = rn(b, s, h, p).to(dtype)
    dt = torch.logaddexp(rn(b, s, h), torch.zeros((), device=dev))
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    bb, cc = ((rn(b, s, h, n) * 0.3).to(dtype) for _ in range(2))
    return (x, dt, a, bb, cc), (rn(b, h, n, p) * 0.2 if h0 else None)


def wkv_case(shape, dtype, dev, seed):
    """rwkv6-like inputs: r/k/v at 0.5, w = z - 6 (its ``decay_base`` plus
    a unit-scale projection: decay ~ 0.9975, long memory), u at 0.3, a
    state at 0.2; r/k/v/w in ``dtype``."""
    b, s, h, state = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*sh):
        return torch.randn(sh, generator=g, device=dev)
    r, k, v = ((rn(b, s, h, 64) * 0.5).to(dtype) for _ in range(3))
    w = (rn(b, s, h, 64) - 6.0).to(dtype)
    return (r, k, v, w, rn(h, 64) * 0.3), \
        (rn(b, h, 64, 64) * 0.2 if state else None)


def scan_bound_ms(nbytes: int, macs: int, dtype) -> tuple[float, str]:
    """The larger of the bytes over HBM and 2 * ``macs`` operations over
    the peak for the inputs' type (bf16 tensor cores, or f32)."""
    rate = BF16_OPS_S if dtype == torch.bfloat16 else F32_OPS_S
    t_bytes, t_ops = nbytes / HBM_BYTES_S, 2 * macs / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ssm_bound_ms(shape, dtype) -> tuple[float, str]:
    """B4's function: x, B, C (dtype), dt (f32), a, h0 (f32, if given) read
    once, y (dtype) and h (f32) written once; the sequential recurrence's
    2 N P multiply-adds a step and head (decay and update of h, and
    C h)."""
    b, s, h, p, n, h0 = shape
    item = torch.tensor([], dtype=dtype).element_size()
    state = b * h * n * p * 4
    nbytes = (b * s * h * (2 * p + 2 * n) * item + b * s * h * 4 + h * 4
              + state * (2 if h0 else 1))
    return scan_bound_ms(nbytes, b * s * h * 2 * n * p, dtype)


def wkv_bound_ms(shape, dtype) -> tuple[float, str]:
    """B5's function: r, k, v, w (dtype), u and the state (f32, if given)
    read once, y (dtype) and the state written once; 3 D^2 multiply-adds
    a step and head (k^T v, its decay-and-add into S, and r S)."""
    b, s, h, state = shape
    d = 64
    item = torch.tensor([], dtype=dtype).element_size()
    st = b * h * d * d * 4
    nbytes = 5 * b * s * h * d * item + h * d * 4 + st * (2 if state else 1)
    return scan_bound_ms(nbytes, b * s * h * 3 * d * d, dtype)


def wkv_f32_floor_ms(shape) -> float:
    """The floor of B5's sequential form on the CUDA cores, whatever the
    inputs' type: its 3 D^2 multiply-adds a step and head (as in
    ``wkv_bound_ms``) over the f32 peak.  The kernel runs every step in
    f32, so this, not the bytes, is the least it can take."""
    b, s, h, _ = shape
    return 2 * b * s * h * 3 * 64 * 64 / F32_OPS_S * 1e3


def scan_phase(dev) -> dict:
    """B4 and B5 against their plain versions in f32 and bf16 at every
    shape, the profiler naming each dtype's kernel; then, in bf16, timed
    beside the plain version and the bound."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_plain
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain
    out = {"ssm_scan": [], "wkv6": []}
    kernels = {"ssm_scan": (ssm_scan_cuda, ssm_scan_plain, ssm_case,
                            SSM_SHAPES, ssm_bound_ms, "h0"),
               "wkv6": (wkv6_cuda, wkv6_plain, wkv_case, WKV_SHAPES,
                        wkv_bound_ms, "state")}
    for kname, (cuda, plain, case, shapes, bound_fn, init) in \
            kernels.items():
        for name, shape in shapes.items():
            long = shape[1] >= 1000
            errs, f32_kern = {}, {}
            for dtype in (torch.float32, torch.bfloat16):
                args, s0 = case(shape, dtype, dev, shape[1] + 7)
                got = cuda(*args, **{init: s0})
                want = plain(*args, **{init: s0})
                torch.cuda.synchronize()
                errs[str(dtype)] = max(
                    close_check(g, w, dtype, f"{kname} {name} {dtype} {o}",
                                SCAN_TOL[dtype])
                    for o, g, w in zip(("y", "state"), got, want))
                if dtype == torch.float32:      # the CUDA-core kernel ran
                    f32_kern = kernel_ms(
                        lambda: cuda(*args, **{init: s0}),
                        SCAN_KERNELS[kname][dtype], 2 if long else 5)
            iters = 10 if long else 200

            def run():
                return cuda(*args, **{init: s0})
            ms = device_ms(run, iters)
            call = call_ms(run, iters)
            plain_ms = device_ms(lambda: plain(*args, **{init: s0}),
                                 2 if long else 20)
            bound, bound_by = bound_fn(shape, torch.bfloat16)
            kern = kernel_ms(run, SCAN_KERNELS[kname][torch.bfloat16],
                             5 if long else 20)
            row = dict(shape=name, dims=list(shape), max_abs_err=errs,
                       ms=ms, call_ms=call, kernel_ms=kern,
                       f32_kernel_ms=f32_kern, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bound, bound_by=bound_by)
            extra = ""
            if kname == "wkv6":
                row["f32_floor_ms"] = wkv_f32_floor_ms(shape)
                extra = (f", f32 CUDA-core floor "
                         f"{row['f32_floor_ms'] * 1e3:.2f} us")
            out[kname].append(row)
            print(f"kernel {kname} {name} {list(shape)}: == plain (max abs "
                  f"err f32 {errs['torch.float32']:.2e}, bf16 "
                  f"{errs['torch.bfloat16']:.2e}); bf16 device "
                  f"{ms * 1e3:.2f} us/launch ({call * 1e3:.2f} us a call "
                  f"back to back; the kernel itself {fmt_us(kern)}), plain "
                  f"{plain_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us "
                  f"({bound_by}){extra}; f32 on {fmt_us(f32_kern)}; no "
                  "library call", flush=True)
    return out


def fmt_us(kern: dict) -> str:
    return ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in kern.items()) \
        or "not seen by the profiler"


def scenarios():
    from repro_torch.cluster.presets import het16_cluster
    from repro_torch.sim import Scenario
    return {"kiss4096": Scenario.kiss(4096.0),
            "het16_size_aware": Scenario.from_cluster(
                het16_cluster("size_aware"))}


def check_result(name: str, run: str, res, n_events: int,
                 golden=None) -> dict:
    """Check the ``run`` of scenario ``name``: shapes, ranges, a finite
    summary, and the JAX reference's digests (``golden``, by default
    ``GOLDEN[name]``).  Returns the summary."""
    what = f"{name}/{run}"
    node, outcome = res.node, res.outcome
    n_nodes = res.scenario.n_nodes
    check(node.shape == outcome.shape == (n_events,), f"{what}: shape")
    check(((node >= 0) & (node < n_nodes)).all(), f"{what}: node range")
    check(np.isin(outcome, (0, 1, 2)).all(), f"{what}: outcome codes")
    summary = res.summary()
    check(all(np.isfinite(v) for v in summary.values()),
          f"{what}: non-finite summary value")
    got = dict(node=digest(node), outcome=digest(outcome),
               counts=np.bincount(outcome, minlength=3).tolist())
    want = GOLDEN[name] if golden is None else golden
    check(got == want, f"{what}: {got} != the JAX reference {want}")
    return summary


def sync_guard_refuses(dev) -> bool:
    """Positive control for ``set_sync_debug_mode("error")``: a host read
    of a device value must raise."""
    try:
        torch.zeros(1, device=dev).item()
    except RuntimeError:
        return True
    return False


class RunCounts:
    """The block runner's counts and B1's launches over one run."""

    def __init__(self):
        from repro_torch.cluster import graphs
        from repro_torch.kernels.pool_step import evict_place_cuda
        self.stats, self.b1 = graphs.STATS, evict_place_cuda
        self.before = (dict(self.stats), self.b1.launches)

    def delta(self) -> dict:
        stats0, b1 = self.before
        out = {k: self.stats[k] - stats0[k] for k in self.stats}
        out["b1_launches"] = self.b1.launches - b1
        return out


def zero_counts() -> None:
    """Set every count of the simulator path to 0 (a path starts)."""
    from repro_torch.cluster import graphs
    from repro_torch.kernels.pool_step import evict_place_cuda
    evict_place_cuda.launches = 0
    for k in graphs.STATS:
        graphs.STATS[k] = type(graphs.STATS[k])(0)


def spans_of(n: int, chunk: int) -> list[int]:
    """The chunk lengths of an ``n``-event run in chunks of ``chunk``."""
    return [min(chunk, n - s) for s in range(0, n, chunk)]


def runner_check(what: str, counts: dict, spans, mode: str) -> None:
    """The runner stepped each span of ``spans`` events as its whole
    blocks (graph replays) and an eager remainder, and a fused run
    launched B1 once an event."""
    from repro_torch.cluster.graphs import BLOCK_EVENTS as k
    want = (sum(c // k for c in spans), sum(c % k for c in spans))
    got = (counts["blocks"], counts["eager_events"])
    check(got == want, f"{what}: (replays, eager events) {got} != {want}")
    b1 = sum(spans) if mode == "fused" else 0
    check(counts["b1_launches"] == b1,
          f"{what}: B1 launched {counts['b1_launches']} times, want {b1}")


def timed_run(what: str, spans, mode: str, fn):
    """Run ``fn`` (one ``simulate``), check the runner's counts, print
    its rate and the share of its wall spent warming up and capturing."""
    counts = RunCounts()
    t0 = time.perf_counter()
    res = fn()
    dt = time.perf_counter() - t0
    c = counts.delta()
    runner_check(what, c, spans, mode)
    n = sum(spans)
    print(f"path {what}: {n} events in {dt:.2f} s = {n / dt:.1f} events/s "
          f"({c['blocks']} graph replays, {c['eager_events']} eager events, "
          f"{c['captures']} captures = {100 * c['capture_s'] / dt:.1f}% of "
          "the wall)", flush=True)
    return res, dict(events=n, wall_s=dt, events_per_s=n / dt, **c)


def timed_sweep(what: str, spans, mode: str, lanes: int, n_events: int,
                fn):
    """Run ``fn`` (one ``sweep`` of ``lanes`` lanes over ``n_events``
    events; ``spans`` its groups' chunk or epoch lengths, one after
    another), check the runner's counts (B1 once a ``fused`` event of
    each group, whatever its lanes), print its lane-events/s and the
    share of its wall spent capturing."""
    counts = RunCounts()
    t0 = time.perf_counter()
    res = fn()
    dt = time.perf_counter() - t0
    c = counts.delta()
    runner_check(what, c, spans, mode)
    rate = lanes * n_events / dt
    print(f"sweep {what}: {lanes} lanes x {n_events} events in {dt:.2f} s "
          f"= {rate:.1f} lane-events/s ({c['blocks']} graph replays, "
          f"{c['eager_events']} eager events, {c['b1_launches']} B1 "
          f"launches, {c['captures']} captures = "
          f"{100 * c['capture_s'] / dt:.1f}% of the wall)", flush=True)
    return res, dict(lanes=lanes, events=n_events, wall_s=dt,
                     lane_events_per_s=rate, **c)


@contextlib.contextmanager
def group_walls(records: list):
    """Record each group a ``sweep`` runs into ``records``: its lanes,
    events and host wall (a group's run ends by reading its results
    back, so the wall holds the device's work) and its capture seconds."""
    from repro_torch.cluster import graphs
    from repro_torch.sim import api
    real = {k: getattr(api, k) for k in ("_run_group",
                                          "_run_group_autoscale")}

    def timed(fn):
        def run(configs, *args, **kw):
            cap0, t0 = graphs.STATS["capture_s"], time.perf_counter()
            out = fn(configs, *args, **kw)
            records.append(dict(
                lanes=len(configs), wall_s=time.perf_counter() - t0,
                capture_s=graphs.STATS["capture_s"] - cap0,
                n_nodes=configs[0].n_nodes))
            return out
        return run
    for k, fn in real.items():
        setattr(api, k, timed(fn))
    try:
        yield
    finally:
        for k, fn in real.items():
            setattr(api, k, fn)


def path_phase(dev, trace) -> dict:
    from repro_torch.cluster.graphs import BLOCK_EVENTS
    from repro_torch.sim import simulate
    from repro_torch.sim.api import trace_fingerprint

    check(trace_fingerprint(trace) == GOLDEN_TRACE,
          "the stored trace differs from the one the reference ran")
    head = trace.head(SIM_EVENTS)
    n, full = len(head), len(trace)
    chunks = spans_of(full, CHUNK_EVENTS)
    modes = ("gather", "vmap", "fused")
    chunked = (("kiss4096", "gather"), ("kiss4096", "vmap"),
               ("kiss4096", "fused"), ("het16_size_aware", "fused"))
    scns = scenarios()
    card, runs = {}, {}
    print(f"path: block runner, {BLOCK_EVENTS} events a graph", flush=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        check(sync_guard_refuses(dev),
              "sync debug mode did not refuse a host sync")
        zero_counts()                       # the main path starts here
        total = RunCounts()
        for name, scn in scns.items():
            for mode in modes:
                res, runs[f"{name}/{mode}"] = timed_run(
                    f"{name} mode={mode} on {dev}", [n], mode,
                    lambda: simulate(scn, head, mode=mode, device=dev))
                check_result(name, mode, res, n)
                card[name, mode] = res
        for name, mode in chunked:
            res, runs[f"{name}/{mode}/chunked"] = timed_run(
                f"{name} mode={mode} chunk_events={CHUNK_EVENTS} on {dev}",
                chunks, mode,
                lambda: simulate(scns[name], trace, mode=mode, device=dev,
                                 chunk_events=CHUNK_EVENTS))
            check_result(name, f"{mode}/chunked", res, full,
                         GOLDEN_FULL[name])
        counts = total.delta()                # ... and ends here
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fused = 2 * n + sum(full for _, m in chunked if m == "fused")
    check(counts["b1_launches"] == fused,
          f"fused runs launched B1 {counts['b1_launches']} times, want "
          f"{fused}")
    print(f"path: matches the JAX reference bitwise; B1 launched "
          f"{counts['b1_launches']} times, once a fused event", flush=True)
    for name, scn in scns.items():
        t0 = time.perf_counter()
        res = simulate(scn, head.head(CPU_EVENTS), mode="gather",
                       device="cpu")
        dt = time.perf_counter() - t0
        for mode in modes:
            got = card[name, mode]
            check(np.array_equal(res.node, got.node[:CPU_EVENTS])
                  and np.array_equal(res.outcome, got.outcome[:CPU_EVENTS]),
                  f"{name}/{mode}: the card's first {CPU_EVENTS} events "
                  "differ from the CPU run")
        runs[f"{name}/gather/cpu"] = dict(events=CPU_EVENTS, wall_s=dt,
                                          events_per_s=CPU_EVENTS / dt)
        print(f"path {name} mode=gather on cpu: {CPU_EVENTS / dt:.1f} "
              f"events/s; equal to the card's runs over its first "
              f"{CPU_EVENTS} events", flush=True)
    return {"launches": counts["b1_launches"], "counts": counts,
            "runs": runs}


def failure_scenario(head):
    """het16 with ``FAIL_WINDOWS`` over ``head``'s time span."""
    from repro_torch.sim import Failures
    t_end = float(head.t[-1])
    return dataclasses.replace(
        scenarios()["het16_size_aware"], failures=Failures(tuple(
            (lo * t_end, hi * t_end, node)
            for lo, hi, node in FAIL_WINDOWS)))


def failure_phase(dev, trace) -> dict:
    """Failure injection on the card: the failure scenario monolithic
    and chunked in every mode, held to the JAX reference's digests,
    invalidations and downtime, chunked equal to monolithic."""
    from repro_torch.sim import simulate
    head = trace.head(SIM_EVENTS)
    n, scn = len(head), failure_scenario(head)
    golden = {k: GOLDEN_FAIL[k] for k in ("node", "outcome", "counts")}
    runs, node_up = {}, None
    torch.cuda.set_sync_debug_mode("error")
    try:
        zero_counts()                       # the failure path starts here
        total = RunCounts()
        for mode in ("gather", "vmap", "fused"):
            for chunk in (None, FAIL_CHUNK):
                spans = spans_of(n, chunk or n)
                what = f"failures mode={mode} chunk_events={chunk}"
                res, runs[f"{mode}/{chunk or 'mono'}"] = timed_run(
                    what, spans, mode,
                    lambda: simulate(scn, head, mode=mode, device=dev,
                                     chunk_events=chunk))
                s = check_result("het16_size_aware", what, res, n, golden)
                check(res.invalidated.tolist() == GOLDEN_FAIL["invalidated"],
                      f"{what}: invalidated {res.invalidated.tolist()}")
                check(s["downtime_pct"] == GOLDEN_FAIL["downtime_pct"],
                      f"{what}: downtime_pct {s['downtime_pct']}")
                if node_up is None:
                    node_up = res.node_up
                check(np.array_equal(res.node_up, node_up),
                      f"{what}: node_up differs from the first run")
                if (mode, chunk) == ("fused", None):
                    kept = res
        counts = total.delta()                # ... and ends here
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"failures: every run matches the JAX reference bitwise "
          f"(invalidated {GOLDEN_FAIL['invalidated'][:3]}..., downtime "
          f"{GOLDEN_FAIL['downtime_pct']}%); B1 launched "
          f"{counts['b1_launches']} times", flush=True)
    return {"launches": counts["b1_launches"], "counts": counts,
            "runs": runs, "oracle_runs": {"het16_failures": (kept, head)}}


def autoscale_scenarios(trace) -> dict:
    """The autoscale phase's two scenarios over the whole ``trace``."""
    from repro_torch.sim import Autoscale, Scenario
    return {
        "kiss4096": Scenario.kiss(
            4096.0, autoscale=Autoscale(epoch_events=ASC_EPOCH)),
        "het16_nodes_failures": dataclasses.replace(
            failure_scenario(trace), autoscale=Autoscale(
                epoch_events=ASC_EPOCH, spawn_drop_frac=0.02,
                retire_drop_frac=0.005, init_active=12))}


def autoscale_digests(res) -> dict:
    """What ``GOLDEN_ASC`` holds of an autoscaled run (of either
    package's ``Result``)."""
    s = res.summary()
    return dict(node=digest(res.node), outcome=digest(res.outcome),
                counts=np.bincount(res.outcome, minlength=3).tolist(),
                fracs=digest(res.fracs, np.float32),
                active=digest(res.active, np.uint8),
                invalidated=np.asarray(res.invalidated).tolist(),
                **{k: s[k] for k in ("n_epochs", "n_invalidated",
                                     "n_active_final", "n_active_min",
                                     "frac_min", "frac_max")})


@contextlib.contextmanager
def timed_calls(owner, name: str, marks: list, keep=lambda *a: True):
    """Record CUDA events around every call of ``owner.name`` for which
    ``keep(*args)`` holds into ``marks``; recording is sync-free, and
    the times are read after the run."""
    real = getattr(owner, name)

    def timed(*args):
        if not keep(*args):
            return real(*args)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = real(*args)
        end.record()
        marks.append((start, end))
        return out
    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, real)


def autoscale_phase(dev, trace) -> dict:
    """Autoscaled runs on the card: both ``autoscale_scenarios`` over the
    whole trace in every mode, under ``set_sync_debug_mode("error")``,
    each epoch one chunk of the block runner (its blocks graph replays,
    its remainder eager) and a re-split between full epochs; held to
    ``GOLDEN_ASC``.  Prints each run's events/s, capture share, counts
    and the shares of the wall of the re-splits and of the eager
    remainder (device time between CUDA events around each re-split and
    each eager remainder, read after the run)."""
    from repro_torch._device import sync_point
    from repro_torch.cluster import engine, graphs
    from repro_torch.sim import simulate
    n = len(trace)
    spans = spans_of(n, ASC_EPOCH)
    scns = autoscale_scenarios(trace)
    runs, marks, eager = {}, [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        check(sync_guard_refuses(dev),
              "sync debug mode did not refuse a host sync")
        zero_counts()                     # the autoscale path starts here
        total = RunCounts()
        # after its capture a runner's ``_advance`` steps only remainders
        with timed_calls(engine, "_epoch_end", marks), \
                timed_calls(graphs.BlockRunner, "_advance", eager,
                            lambda runner, *a: runner.graph is not None):
            for name, scn in scns.items():
                for mode in ("gather", "vmap", "fused"):
                    marks.clear()
                    eager.clear()
                    what = f"autoscale {name} mode={mode}"
                    res, run = timed_run(
                        what, spans, mode,
                        lambda: simulate(scn, trace, mode=mode, device=dev))
                    if (name, mode) == ("kiss4096", "fused"):
                        kept = res
                    got = autoscale_digests(res)
                    check(got == GOLDEN_ASC[name],
                          f"{what}: {got} != the JAX reference "
                          f"{GOLDEN_ASC[name]}")
                    check(all(np.isfinite(v) for v in
                              res.summary().values()),
                          f"{what}: non-finite summary value")
                    with sync_point(dev):
                        ms = sum(a.elapsed_time(b) for a, b in marks)
                        eager_ms = sum(a.elapsed_time(b) for a, b in eager)
                    wall = run["wall_s"]
                    run.update(resplits=len(marks), resplit_s=ms / 1e3,
                               resplit_share=ms / 1e3 / wall,
                               eager_s=eager_ms / 1e3,
                               eager_share=eager_ms / 1e3 / wall)
                    runs[f"{name}/{mode}"] = run
                    print(f"  re-split: {len(marks)} epoch ends, "
                          f"{ms:.2f} ms on the device = "
                          f"{100 * run['resplit_share']:.2f}% of the wall; "
                          f"eager remainder {eager_ms:.2f} ms = "
                          f"{100 * run['eager_share']:.2f}%; n_active "
                          f"{res.n_active.min()}-{res.n_active.max()}, "
                          f"{res.n_invalidated} invalidated", flush=True)
        counts = total.delta()                # ... and ends here
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(counts["b1_launches"] == 2 * n,
          f"autoscaled fused runs launched B1 {counts['b1_launches']} "
          f"times, want {2 * n}")
    print(f"autoscale: every run matches the JAX reference bitwise; B1 "
          f"launched {counts['b1_launches']} times", flush=True)
    return {"launches": counts["b1_launches"], "counts": counts,
            "runs": runs,
            "oracle_runs": {"autoscale_kiss4096": (kept, trace)}}


def telemetry_scenarios(trace) -> dict:
    """The telemetry phase's two scenarios over the whole ``trace``."""
    from repro_torch.sim import Scenario
    return {
        "size_aware_4n": Scenario.cluster(
            (1024.0, 2048.0, 6144.0, 6144.0), routing="size_aware",
            max_slots=256, telemetry=TEL_WINDOW),
        "het16_nodes_failures": dataclasses.replace(
            autoscale_scenarios(trace)["het16_nodes_failures"],
            telemetry=CHAIN_WINDOW)}


def chain_scenarios() -> dict:
    """The chain phase's scenarios, one a routing policy."""
    from repro_torch.sim import Chains, Scenario
    return {r: Scenario.cluster((2048.0, 2048.0), routing=r, max_slots=256,
                                chains=Chains(slack=4.0),
                                failures=CHAIN_OUTAGE, telemetry=CHAIN_WINDOW)
            for r in ("slack_aware", "size_aware")}


#: The telemetry window arrays and per-chain arrays ``tel_digests`` holds.
TEL_ARRAYS = ("counts", "free_mb", "occupancy", "invalidated", "nodes_up",
              "nodes_active", "chain_miss", "t_start", "t_end",
              "event_start")
CHAIN_ARRAYS = ("latency", "dropped", "done", "missed", "deadline")


def tel_digests(res) -> dict:
    """What ``GOLDEN_TEL`` and ``GOLDEN_CHAIN`` hold of a run (of either
    package's ``Result``): digests of ``node``/``outcome``, of every
    telemetry window array (``tel_*``) and every per-chain array
    (``chain_*``) in its own dtype, and of the whole ``summary()`` (its
    JSON), with a few summary keys in the clear."""
    s = res.summary()
    out = dict(node=digest(res.node), outcome=digest(res.outcome),
               counts=np.bincount(res.outcome, minlength=3).tolist(),
               summary=hashlib.blake2s(json.dumps(
                   s, sort_keys=True).encode()).hexdigest(),
               **{k: s[k] for k in ("n_windows", "n_chains",
                                    "deadline_miss_pct", "n_invalidated")})
    for pre, owner, fields in (("tel_", res.telemetry, TEL_ARRAYS),
                               ("chain_", res.chains, CHAIN_ARRAYS)):
        for f in fields if owner is not None else ():
            a = np.asarray(getattr(owner, f))
            out[pre + f] = digest(a, a.dtype)
    return out


def telemetry_phase(dev, trace) -> dict:
    """Telemetry and chains on the card, under
    ``set_sync_debug_mode("error")``, every count zeroed before and read
    after: ``telemetry_scenarios``' 4-node cluster over the whole trace in
    every mode, monolithic and in chunks of ``TEL_CHUNK``, and the same
    scenario without telemetry (its outcomes must not move; the
    overhead compares the two monolithic runs' walls without their
    capture); ``chain_scenarios`` over the chain benchmark's trace as
    the two lanes of one sweep in ``gather`` and in ``vmap`` (in
    ``fused`` they are lanes of the sweep phase's chain grid),
    ``slack_aware`` in ``fused`` in chunks of
    ``CHAIN_CHUNK``; and het16 autoscaled with telemetry in ``fused``.
    Every run goes through the block runner (its counts and B1's are
    checked) and is held to ``GOLDEN_TEL``/``GOLDEN_CHAIN``."""
    from repro_torch.sim import simulate, sweep
    from repro_torch.sim.api import trace_fingerprint
    from repro_torch.workloads import benchmark_chained_trace
    ctr = benchmark_chained_trace()
    check(trace_fingerprint(ctr) == GOLDEN_CHAINED_TRACE,
          "the stored chained trace differs from the one the reference ran")
    tel, chains = telemetry_scenarios(trace), chain_scenarios()
    n, nc = len(trace), len(ctr)
    runs, fused = {}, 0

    def held(name, run, what, spans, mode, scn, tr, golden, chunk=None):
        nonlocal fused
        res, runs[run] = timed_run(
            what, spans, mode,
            lambda: simulate(scn, tr, mode=mode, device=dev,
                             chunk_events=chunk))
        got = tel_digests(res)
        check(got == golden[name],
              f"{what}: {got} != the JAX reference {golden[name]}")
        check(all(np.isfinite(v) for v in res.summary().values()),
              f"{what}: non-finite summary value")
        fused += sum(spans) if mode == "fused" else 0
        return res

    torch.cuda.set_sync_debug_mode("error")
    try:
        check(sync_guard_refuses(dev),
              "sync debug mode did not refuse a host sync")
        zero_counts()                   # the telemetry path starts here
        total = RunCounts()
        scn = tel["size_aware_4n"]
        off = dataclasses.replace(scn, telemetry=None)
        for mode in ("gather", "vmap", "fused"):
            on = held("size_aware_4n", f"tel/{mode}",
                      f"telemetry size_aware_4n mode={mode}", [n], mode,
                      scn, trace, GOLDEN_TEL)
            held("size_aware_4n", f"tel/{mode}/chunked",
                 f"telemetry size_aware_4n mode={mode} "
                 f"chunk_events={TEL_CHUNK}", spans_of(n, TEL_CHUNK), mode,
                 scn, trace, GOLDEN_TEL, TEL_CHUNK)
            res, runs[f"off/{mode}"] = timed_run(
                f"no telemetry size_aware_4n mode={mode}", [n], mode,
                lambda: simulate(off, trace, mode=mode, device=dev))
            fused += n if mode == "fused" else 0
            check(np.array_equal(res.node, on.node)
                  and np.array_equal(res.outcome, on.outcome),
                  f"mode={mode}: telemetry moved the outcomes")
            r_on, r_off = runs[f"tel/{mode}"], runs[f"off/{mode}"]
            over = ((r_on["wall_s"] - r_on["capture_s"])
                    / (r_off["wall_s"] - r_off["capture_s"]) - 1.0)
            r_on["overhead"] = over
            print(f"  telemetry overhead, mode={mode}: {100 * over:.1f}% "
                  "of the run without it (walls less capture)", flush=True)
        for mode in ("gather", "vmap"):       # fused: the chain grid's
            lanes, runs[f"chains/{mode}"] = timed_sweep(
                f"chains mode={mode}", [nc], mode, len(chains), nc,
                lambda: sweep(ctr, list(chains.values()), mode=mode,
                              device=dev))
            for name, res in zip(chains, lanes):
                got = tel_digests(res)
                check(got == GOLDEN_CHAIN[name],
                      f"chains {name} mode={mode}: {got} != the JAX "
                      f"reference {GOLDEN_CHAIN[name]}")
                check(all(np.isfinite(v) for v in res.summary().values()),
                      f"chains {name} mode={mode}: non-finite summary "
                      "value")
        held("slack_aware", "chains/slack_aware/fused/chunked",
             f"chains slack_aware mode=fused chunk_events={CHAIN_CHUNK}",
             spans_of(nc, CHAIN_CHUNK), "fused", chains["slack_aware"], ctr,
             GOLDEN_CHAIN, CHAIN_CHUNK)
        held("het16_nodes_failures", "tel/het16_nodes_failures/fused",
             "telemetry het16 autoscaled mode=fused",
             spans_of(n, ASC_EPOCH), "fused", tel["het16_nodes_failures"],
             trace, GOLDEN_TEL)
        counts = total.delta()                # ... and ends here
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(counts["b1_launches"] == fused,
          f"telemetry and chain runs launched B1 {counts['b1_launches']} "
          f"times, want {fused}")
    print(f"telemetry and chains: every run matches the JAX reference "
          f"bitwise; B1 launched {counts['b1_launches']} times; "
          f"{counts['captures']} captures", flush=True)
    return {"launches": counts["b1_launches"], "counts": counts,
            "runs": runs}


def vertical_lanes() -> dict:
    """``benchmarks/vertical.py``'s four lanes, by their names there."""
    from repro_torch.sim import Resize, Scenario
    rz = Resize("fair_share", min_mb=RZ_MIN_MB)

    def lane(name, **kw):
        return Scenario.cluster(RZ_NODE_MB, routing="size_aware",
                                max_slots=RZ_SLOTS, name=name, **kw)
    return {"kiss_static": lane("kiss_static"),
            "kiss_rz_static": lane("kiss_rz_static", resize="static"),
            "vertical_dynamic": lane("vertical_dynamic", unified=True,
                                     resize=rz),
            "hybrid": lane("hybrid", resize=rz)}


def vertical_scenarios(trace, replay) -> dict:
    """The vertical phase's runs by their ``GOLDEN_RZ`` names, each a
    ``(scenario, trace)``: the four lanes on the quickstart ``trace``, the
    hybrid there with the failure phase's outages over the whole trace,
    autoscaled every ``ASC_EPOCH`` events and with windows of
    ``TEL_WINDOW`` events, and the hybrid and the unified lane on the
    ``replay`` trace."""
    from repro_torch.sim import Autoscale, Failures
    lanes = vertical_lanes()
    hyb, t_end = lanes["hybrid"], float(trace.t[-1])
    fails = Failures(tuple((lo * t_end, hi * t_end, node)
                           for lo, hi, node in FAIL_WINDOWS))
    out = {name: (scn, trace) for name, scn in lanes.items()}
    out.update(
        hybrid_failures=(dataclasses.replace(
            hyb, name="hybrid_failures", failures=fails), trace),
        hybrid_autoscale=(dataclasses.replace(
            hyb, name="hybrid_autoscale",
            autoscale=Autoscale(epoch_events=ASC_EPOCH)), trace),
        hybrid_telemetry=(dataclasses.replace(
            hyb, name="hybrid_telemetry", telemetry=TEL_WINDOW), trace),
        hybrid_replay=(hyb, replay),
        vertical_dynamic_replay=(lanes["vertical_dynamic"], replay))
    return out


#: The vertical phase's ``simulate`` runs, in order: ``(GOLDEN_RZ name,
#: mode, chunk_events)``.
VERTICAL_RUNS = (
    ("hybrid", "gather", None), ("hybrid", "vmap", None),
    ("hybrid", "fused", None), ("hybrid", "fused", CHUNK_EVENTS),
    ("kiss_static", "fused", None), ("hybrid_failures", "fused", None),
    ("hybrid_autoscale", "fused", None), ("hybrid_telemetry", "fused", None))
#: The vertical runs made as sweeps: the phase's own ``fused`` sweep of
#: the unified and the ``static`` resize lanes (one group: resize on, the
#: hybrid's shape), and the sweep phase's ``vertical_replay`` (its lanes'
#: ``GOLDEN_RZ`` names).
VERTICAL_SWEEP = ("vertical_dynamic", "kiss_rz_static")
REPLAY_LANES = {"vertical_dynamic": "vertical_dynamic_replay",
                "hybrid": "hybrid_replay"}
#: The ``Result.vertical`` arrays ``rz_digests`` holds.
VERTICAL_ARRAYS = ("acc_used_mb", "acc_alloc_mb", "bottlenecks")
#: The summary keys only vertical scaling may move.
VERTICAL_KEYS = ("utilization_ratio", "bottleneck_events")


def rz_digests(res) -> dict:
    """What ``GOLDEN_RZ`` holds of a run (of either package's
    ``Result``): ``tel_digests`` (node, outcome, the whole summary and any
    window arrays), the vertical summary keys in the clear, and digests
    of the three ``Result.vertical`` arrays in their own dtypes."""
    out = tel_digests(res)
    s = res.summary()
    out.update({k: s[k] for k in VERTICAL_KEYS})
    for k in VERTICAL_ARRAYS if res.vertical is not None else ():
        a = np.asarray(res.vertical[k])
        out["vert_" + k] = digest(a, a.dtype)
    return out


def rz_check(what: str, res, name: str) -> dict:
    """Hold a vertical run (or sweep lane) to ``GOLDEN_RZ[name]``, with a
    finite summary and, under ``fair_share``, bottleneck events (the
    shrink ran); returns the summary."""
    got = rz_digests(res)
    check(got == GOLDEN_RZ[name],
          f"{what}: {got} != the JAX reference {GOLDEN_RZ[name]}")
    s = res.summary()
    check(all(np.isfinite(v) for v in s.values()),
          f"{what}: non-finite summary value")
    rz = res.scenario.resize
    if rz is not None and rz.policy == "fair_share":
        check(s["bottleneck_events"] > 0,
              f"{what}: no bottleneck event, so no shrink ran")
    return s


def vertical_phase(dev, trace) -> dict:
    """Vertical scaling on the card, under ``set_sync_debug_mode("error")``,
    every count zeroed before and read after: ``VERTICAL_RUNS`` over
    ``vertical_scenarios`` through ``simulate`` (the hybrid in every
    mode, monolithic and in chunks of ``CHUNK_EVENTS``; no resize, the
    outages, the autoscaler and telemetry in ``fused``), and the
    ``VERTICAL_SWEEP`` lanes as one ``fused`` sweep (the whole replay
    trace is the sweep phase's).  Every run goes through the block runner
    (its counts and B1's are checked) and is held to ``GOLDEN_RZ``; the
    ``static`` resize lane's outcome keys must equal no resize's
    (``benchmarks/vertical.py``'s ``vertical_static_noop``), and every
    ``fair_share`` run must have served bottleneck events (the shrink
    ran).  Prints each run's events/s and resize's overhead: the hybrid
    against ``kiss_static`` in ``fused``, walls less capture."""
    from repro_torch.sim import simulate, sweep
    scns = vertical_scenarios(trace, None)
    runs, summaries, fused = {}, {}, 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        check(sync_guard_refuses(dev),
              "sync debug mode did not refuse a host sync")
        zero_counts()                    # the vertical path starts here
        total = RunCounts()
        for name, mode, chunk in VERTICAL_RUNS:
            scn, tr = scns[name]
            n = len(tr)
            spans = (spans_of(n, ASC_EPOCH) if scn.autoscale is not None
                     else spans_of(n, chunk or n))
            run = f"{name}/{mode}" + ("/chunked" if chunk else "")
            what = f"vertical {name} mode={mode} chunk_events={chunk}"
            res, runs[run] = timed_run(
                what, spans, mode,
                lambda: simulate(scn, tr, mode=mode, device=dev,
                                 chunk_events=chunk))
            summaries[run] = rz_check(what, res, name)
            fused += n if mode == "fused" else 0
        n = len(trace)
        what = f"vertical sweep {'+'.join(VERTICAL_SWEEP)} mode=fused"
        lanes, runs["sweep/fused"] = timed_sweep(
            what, [n], "fused", len(VERTICAL_SWEEP), n,
            lambda: sweep(trace, [scns[k][0] for k in VERTICAL_SWEEP],
                          mode="fused", device=dev))
        for name, res in zip(VERTICAL_SWEEP, lanes):
            summaries[f"{name}/fused"] = rz_check(f"{what} lane {name}",
                                                  res, name)
        fused += n
        counts = total.delta()                # ... and ends here
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(counts["b1_launches"] == fused,
          f"vertical runs launched B1 {counts['b1_launches']} times, want "
          f"{fused}")
    plain, static = (summaries[f"{k}/fused"]
                     for k in ("kiss_static", "kiss_rz_static"))
    drift = sorted(k for k in plain if k not in VERTICAL_KEYS
                   and static[k] != plain[k])
    check(not drift, f"the static resize policy moved {drift}")
    r_on, r_off = runs["hybrid/fused"], runs["kiss_static/fused"]
    over = ((r_on["wall_s"] - r_on["capture_s"])
            / (r_off["wall_s"] - r_off["capture_s"]) - 1.0)
    r_on["overhead"] = over
    print(f"vertical: every run matches the JAX reference bitwise; B1 "
          f"launched {counts['b1_launches']} times; {counts['captures']} "
          f"captures; static resize == no resize on every outcome key; "
          f"hybrid {summaries['hybrid/fused']['bottleneck_events']} "
          f"bottleneck events, utilization "
          f"{summaries['hybrid/fused']['utilization_ratio']:.4f}; resize "
          f"overhead in fused {100 * over:.1f}% (hybrid against "
          "kiss_static, walls less capture)", flush=True)
    return {"launches": counts["b1_launches"], "counts": counts,
            "runs": runs, "overhead": over}


#: The sweep phase (``sweep_phase``): the repo's own grids through
#: ``repro_torch.sim.sweep``, at their users' sizes, on stored traces.
#: ``edge_grid`` is ``examples/kiss_edge_sim.py``'s (the Fig 7/8/9 grid:
#: ``EDGE_MEMS`` GB x ``EDGE_SPLITS`` KiSS lanes, a ``Scenario.baseline``
#: lane and a ``Scenario.kiss`` lane autoscaled every ``ASC_EPOCH``
#: events a memory size; 48 lanes, two groups, over the quickstart
#: trace; the README quickstart's 8-lane sweep is part of it);
#: ``routing_grid`` is ``benchmarks/continuum_bench.py``'s
#: ``routing_comparison`` (``het16_cluster`` under every registered
#: routing); ``chain_grid`` is ``benchmarks/chains.py``'s (every
#: registered routing x ``CHAIN_REGIMES`` on two 2 GB nodes with
#: ``CHAIN_OUTAGE``, over the stored chained trace), with windows of
#: ``CHAIN_WINDOW`` events; ``vertical_replay`` is
#: ``benchmarks/vertical.py``'s resize lanes ``vertical_dynamic`` and
#: ``hybrid`` over the stored replay trace in chunks of
#: ``RZ_REPLAY_CHUNK``.  ``GOLDEN_SWEEP`` holds, for every lane, its
#: outcome counts and the blake2s of ``sweep_digests`` (node, outcome,
#: the whole summary, every window, per-chain and vertical array and the
#: epoch, membership and failure arrays) of the JAX reference's
#: ``repro.sim.sweep`` of the same grid (``gather``; the routing grid
#: also over its ``SIM_EVENTS`` head), pinned by
#: ``tests/test_torch_sweep.py``.
GB = 1024.0
EDGE_MEMS = (2, 3, 4, 6, 8, 10, 12, 16)
EDGE_SPLITS = (0.9, 0.8, 0.7, 0.5)
CHAIN_REGIMES = (("none", None), ("tight", 4.0), ("loose", 8.0))
#: The sharded rehearsal's shard counts (``sharded_sweeps``): the chain
#: grid's 18 lanes in 4 shards of 5 (2 pad lanes), the edge grid's 8
#: autoscaled lanes in 3 shards of 3 (1 pad lane).
SHARD_CHAIN = 4
SHARD_ASC = 3
GOLDEN_SWEEP = {
    "edge_grid": {
        "kiss_2g_0.9": ([2755, 6622, 1838],
            "1a3a317e88930026e2f0646cbffd41af4ba2ca2e934f4893ebff4f8a95b8e0bd"),
        "kiss_2g_0.8": ([2256, 7299, 1660],
            "2c2a4999d66712c6b78fcb209abb864bb35a408df52e300d495c3783efce79fc"),
        "kiss_2g_0.7": ([1660, 7878, 1677],
            "e57e005679ceeced60b29a2e5cf6931d2c890381859ca8d43e9613ff19a54d5c"),
        "kiss_2g_0.5": ([773, 8290, 2152],
            "f10d88048d8ed41f6c4a2dc0438357bd5415602612b56f0079d94601605f294f"),
        "kiss_3g_0.9": ([5231, 4146, 1838],
            "2e1d97e3899938b483179e10c665d9e6453ae1def162c068c6b869bea7df48fc"),
        "kiss_3g_0.8": ([4494, 5061, 1660],
            "baaf5051d8cfc22ed8d1841fa1f53e4eecf5cd833a08c2a2868c7abf61c59ce0"),
        "kiss_3g_0.7": ([3811, 5960, 1444],
            "ad4bb8295ba44a182d4a346984ff63ebbb9eb90db78ecb2109eb92f29051dd50"),
        "kiss_3g_0.5": ([2298, 7822, 1095],
            "1ef57a715fd179b6425ba4fa2e9d88f07f3a00bd3415b979c6def9537aa527ca"),
        "kiss_4g_0.9": ([7659, 1896, 1660],
            "295c45e80a41615e433debc5a88aee7f7e1ef1e5a6a0ca10c93e2187c9cc088e"),
        "kiss_4g_0.8": ([6783, 2988, 1444],
            "783e56b7a739fe249ed6fdf680a7cf1955ea9f68359c32b56e8ee41260f3deec"),
        "kiss_4g_0.7": ([5842, 4089, 1284],
            "f27b55ffabf3aaecdb4adf0fc6a4c4c430967033ee7c706271a3b81d7a1645d8"),
        "kiss_4g_0.5": ([3831, 6445, 939],
            "3af53fb43c37d309287f3ce46c47e297823e25a176725359efba154a20f35f92"),
        "kiss_6g_0.9": ([9092, 463, 1660],
            "120a167280586280ea0a0784c9f5b96a709d5bcf3b22e1bfdd3f02df36ab1fa7"),
        "kiss_6g_0.8": ([9227, 704, 1284],
            "6d3cdec4589600997ece91dca863952cd721e29f4ab3f86f4927b52383d9c862"),
        "kiss_6g_0.7": ([9196, 1125, 894],
            "e756fdbee1147c47199729f4870a2eb707119167291c0a5739b17ff94865dfab"),
        "kiss_6g_0.5": ([7184, 3701, 330],
            "f84ca0557d827e37dbd23e7ca91d5a6ee84d4980c757b92f12f6d3b6f497f5e4"),
        "kiss_8g_0.9": ([9338, 433, 1444],
            "a32f54279a156b9fff06bada4b931e71059ce89f3d4dea7912249016b43b3df9"),
        "kiss_8g_0.8": ([9476, 624, 1115],
            "d0cda5e9ccfce47404dd5a5aa63826348ed3bf3c0012247f65e727101925d656"),
        "kiss_8g_0.7": ([9713, 783, 719],
            "e42fa88654a883eac52c2632dab700b0d08c05b8ff7dc3aa57e07aed03b162e8"),
        "kiss_8g_0.5": ([10159, 1056, 0],
            "23d1c5998314ce91377624ab7d0439c03d718f64368e3547f56a670b37d94225"),
        "kiss_10g_0.9": ([9387, 416, 1412],
            "966211413a88376296193a3520ec81278d2ac268ded6d710de58a87fab676eda"),
        "kiss_10g_0.8": ([9655, 621, 939],
            "0fa4c86512a6472bdb9ea669bb0f1e42b0f9a83370fd050aae77633298fa47a6"),
        "kiss_10g_0.7": ([10222, 663, 330],
            "3e777af2c12f7309cc9839ff467c6808f9cf223f1e6f84f319c25c712a8025be"),
        "kiss_10g_0.5": ([10781, 434, 0],
            "701f6b6968f05385e000dab2ea2d72794fbe80a7760a08f01189e15a087014e9"),
        "kiss_12g_0.9": ([9465, 466, 1284],
            "dc69ed0892259c6ed39becde213dd5b67b621ce6ce7bbff095f2f0edb3bc7ce7"),
        "kiss_12g_0.8": ([9852, 644, 719],
            "d9f2dd58a067f8daf4831147cfc772345dc3b901a3806941354f3078b353a138"),
        "kiss_12g_0.7": ([10926, 287, 2],
            "26764a1abce95f759ae9c063b8ea063f94a3544f9bc08831bd52f33105995c5b"),
        "kiss_12g_0.5": ([10881, 334, 0],
            "a953a74ce516dba72885ffcadfde1e4ed2175d8d70c973ab13250252a3538463"),
        "kiss_16g_0.9": ([9567, 533, 1115],
            "416824c35aed45a341b96d2fb0473729c536e6ed681be0ba38c3b01691b9834e"),
        "kiss_16g_0.8": ([10619, 487, 109],
            "1989a8ece936f2c0e1bf4f1be753b0e5ea0bb13b9627ee3ed17864aac694fd4f"),
        "kiss_16g_0.7": ([10983, 232, 0],
            "da69621dbcf23dae36e8ecb51336c90f1d7e044c8ce83c5872c626117dd0db42"),
        "kiss_16g_0.5": ([10975, 240, 0],
            "15febccfa506e013edebdf1c21ba8052d9e5bc12f6e4f28e22b334dfc3fa628d"),
        "baseline_2g": ([388, 7801, 3026],
            "ac5441de214f679233f340140d93c0f49c89749b938f602423baa89578859932"),
        "baseline_3g": ([640, 8279, 2296],
            "0132dc2f7b7410b6be0053e657d83e505309a692e54e44e29683b2b4d86809bb"),
        "baseline_4g": ([1096, 8619, 1500],
            "568895b4b1a45d259ad3a4dd6e1841f92a044b30e5453512c088760f1ff1beb2"),
        "baseline_6g": ([7398, 3817, 0],
            "20129b8d14b7d74bf39623378d5bf1ad90a78d8841022d59bfe37191ce1dd833"),
        "baseline_8g": ([10526, 689, 0],
            "1f0c8c071214ac8c9352e3b12e634708cc5000676f43a54c327bf12525418004"),
        "baseline_10g": ([10845, 370, 0],
            "df54db3aeb96383f0e9f7de2058458bd36328b08754bc40d0a32943255802b35"),
        "baseline_12g": ([10948, 267, 0],
            "e145076a872d02ddb06f4a535837739027df8b760daba0e88ab657ee040b7eb7"),
        "baseline_16g": ([10990, 225, 0],
            "3ccf9be89b6d6ede74ab689d804ce3f4f1aa2a81a2847e7bac51f2bee7afa1ea"),
        "adaptive_2g": ([2740, 6669, 1806],
            "e32560fa1aa3cdf8351ceabc32d03dd48451a512247b05c2d2240c8d85260392"),
        "adaptive_3g": ([5144, 4326, 1745],
            "eb11ef659d7e10dc70612459d0507ba69c8ca2aa3f278e1474a3d77957a41454"),
        "adaptive_4g": ([6707, 3130, 1378],
            "9dd977dadb023375a6c15321ae636a0c008ebac4f8b7e15cb9068ace7e29fffe"),
        "adaptive_6g": ([8566, 1935, 714],
            "2014804ac94439835fbb2e827fb8d7bce05daaa3c571f493ca353343e28b580c"),
        "adaptive_8g": ([10089, 800, 326],
            "9545340d9e8309df13af0b8ac8a17c6c148d2dd52e1cc1291b5071f322ea17dd"),
        "adaptive_10g": ([10472, 545, 198],
            "1118476954c20779ed3556cbff7c514cc51653775b57c7f85f641454eaa4dee8"),
        "adaptive_12g": ([10666, 412, 137],
            "3aa6a412ae8a8c9efd1fc2899bae3b8c9494d191ad438c50f139e65b41612d29"),
        "adaptive_16g": ([10731, 380, 104],
            "fa123792f3ecf451bc4d11f0497211d4f49c4a7d942375cc4866fcf61e893372"),
    },
    "routing_grid": {
        "sticky": ([10732, 218, 265],
            "1ed311fc4ea515c7b6272e7366b4fb55bb908cf7e644715b66c8b712c8415c34"),
        "least_loaded": ([8014, 1343, 1858],
            "eaf9efb45ba2d86235a4871429e4e82818195d0b37617678ef27dfab026f4107"),
        "size_aware": ([10920, 222, 73],
            "bf0f482437097b715873d4de8b56fc90c6fe67523e8a72007358cef4ac32d6d8"),
        "power_of_two": ([9516, 260, 1439],
            "1025f038200e68bb9a34309ee715bd63eb4fc08b1bc6233ed94ddcfc7982658e"),
        "cost_model": ([5386, 3390, 2439],
            "9697a453c2abec64ae76a9f8e06b0836db7859691d8884298feee25dc1a02237"),
        "slack_aware": ([10732, 218, 265],
            "1ed311fc4ea515c7b6272e7366b4fb55bb908cf7e644715b66c8b712c8415c34"),
    },
    "routing_grid_head": {
        "sticky": ([3714, 177, 109],
            "cdbfb90807c15d16766844a5374517cf83cc59003cf48f7ea85a885773d11781"),
        "least_loaded": ([2477, 802, 721],
            "19497a13f3c20ba327896cd67a83562f6a324b7f0f6d39e8ca9d92ea816d1e94"),
        "size_aware": ([3785, 180, 35],
            "283dd7ac259ef974aa097f0a2b05430e76f0bc5f962837b3bde6be6f870b5508"),
        "power_of_two": ([3229, 214, 557],
            "32e18e7f1a739dc7f6c81a4bbced7135cac746aaea79b89be1bb69a9a506bcb8"),
        "cost_model": ([2487, 830, 683],
            "e4046e77d9347a8cd7e4cfabd0c691a0dd67d2c7dad85b5bbbc82f7f3c46dc7f"),
        "slack_aware": ([3714, 177, 109],
            "cdbfb90807c15d16766844a5374517cf83cc59003cf48f7ea85a885773d11781"),
    },
    "chain_grid": {
        "sticky-none": ([1439, 5264, 373],
            "3a736194eea75786630f7f8285966efbc223223afd605cf8e84e1f83e27c7276"),
        "sticky-tight": ([1439, 5264, 373],
            "cda1c13feef5ad2aa04ce88f61806b850cea067c7d17e8e9f66512955266f87c"),
        "sticky-loose": ([1439, 5264, 373],
            "49e8c401d877094d40c08210c5635219de3741d36dfee70fb40643a8166e3aa4"),
        "least_loaded-none": ([587, 6049, 440],
            "fb650a0471e96563a227404aef6da3bd75aa00f01530443c650a32febc99a5b6"),
        "least_loaded-tight": ([587, 6049, 440],
            "4d8794cb8ae8e80b68c4b54a954dc787a7e60fa72d38aaf5bf0b255611201177"),
        "least_loaded-loose": ([587, 6049, 440],
            "f2929a781293e9959a8ee244e3d3903fbb629e6793a3e3f0b0f35677d738d96e"),
        "size_aware-none": ([1439, 5264, 373],
            "3a736194eea75786630f7f8285966efbc223223afd605cf8e84e1f83e27c7276"),
        "size_aware-tight": ([1439, 5264, 373],
            "cda1c13feef5ad2aa04ce88f61806b850cea067c7d17e8e9f66512955266f87c"),
        "size_aware-loose": ([1439, 5264, 373],
            "49e8c401d877094d40c08210c5635219de3741d36dfee70fb40643a8166e3aa4"),
        "power_of_two-none": ([1271, 4638, 1167],
            "be17e8177bba9815416d6cf6bfe3eda812c7f887ded72dd3822c7af910e07c77"),
        "power_of_two-tight": ([1271, 4638, 1167],
            "11c5e1de0544a2dde5161fdf5ccad42dab31dd1a80be977f3a10abc45764703a"),
        "power_of_two-loose": ([1271, 4638, 1167],
            "4d9734b74d4071b5d8faefbfd10963830b894b357422b4dcba446ec0f901a2b9"),
        "cost_model-none": ([287, 3064, 3725],
            "e2a3ee950fa2c3c9ac2d7d74cfe71414a3d88de1e11f4b14d23641de4ef7ae0e"),
        "cost_model-tight": ([287, 3064, 3725],
            "761cab1b860edaf596f46acbc804123a3e63178b872587472ef3e9b5ef829cd8"),
        "cost_model-loose": ([287, 3064, 3725],
            "74025ecfa0c78b2aec1939286f85a0077ac9660217200f6ed45e2d7a6e0f8aa1"),
        "slack_aware-none": ([1439, 5264, 373],
            "3a736194eea75786630f7f8285966efbc223223afd605cf8e84e1f83e27c7276"),
        "slack_aware-tight": ([1644, 3916, 1516],
            "9f7f0e384fbd5fd7fbfa6b3ce8d3a061226ba799c7c0a29c5cb0bc22d1e03ee7"),
        "slack_aware-loose": ([1524, 4624, 928],
            "71f0e52004d6af81beeb2fea9002b9131db10746ef1ec457e7004d70946c675c"),
    },
}


def edge_grid() -> dict:
    """``examples/kiss_edge_sim.py``'s 48 lanes by name, in its order."""
    from repro_torch.sim import Autoscale, Scenario
    out = {f"kiss_{m}g_{f}": Scenario.kiss(m * GB, small_frac=f)
           for m in EDGE_MEMS for f in EDGE_SPLITS}
    out.update({f"baseline_{m}g": Scenario.baseline(m * GB)
                for m in EDGE_MEMS})
    out.update({f"adaptive_{m}g": Scenario.kiss(
        m * GB, autoscale=Autoscale(epoch_events=ASC_EPOCH))
        for m in EDGE_MEMS})
    return out


def routing_grid() -> dict:
    """``routing_comparison``'s lanes: ``het16_cluster`` under each
    registered routing, by its name."""
    from repro_torch.cluster.presets import het16_cluster
    from repro_torch.sim import Scenario, routing_policies
    return {r: Scenario.from_cluster(het16_cluster(r), name=r)
            for r in routing_policies()}


def chain_grid() -> dict:
    """``benchmarks/chains.py``'s ``chain_grid``: every registered
    routing x ``CHAIN_REGIMES``, by ``routing-regime``, with windows of
    ``CHAIN_WINDOW`` events."""
    from repro_torch.sim import Chains, Scenario, routing_policies
    return {f"{r}-{regime}": Scenario.cluster(
        (2048.0, 2048.0), routing=r, max_slots=256,
        chains=Chains(slack=slack), failures=CHAIN_OUTAGE,
        telemetry=CHAIN_WINDOW, name=f"{r}-{regime}")
        for r in routing_policies() for regime, slack in CHAIN_REGIMES}


def vertical_replay_lanes() -> dict:
    """``benchmarks/vertical.py``'s resize lanes, for the replay trace."""
    lanes = vertical_lanes()
    return {k: lanes[k] for k in ("vertical_dynamic", "hybrid")}


def sweep_digests(res) -> dict:
    """What ``GOLDEN_SWEEP`` holds of a lane (of either package's
    ``Result``): ``rz_digests`` and digests of the epoch, membership and
    failure arrays, where the lane has them."""
    out = rz_digests(res)
    for k in ("fracs", "active", "invalidated", "node_up"):
        a = getattr(res, k)
        if a is not None:
            a = np.asarray(a)
            out[k] = digest(a, a.dtype)
    return out


def sweep_golden(res) -> tuple:
    """A lane's ``GOLDEN_SWEEP`` entry: its outcome counts and the
    blake2s of its ``sweep_digests``' JSON."""
    return (np.bincount(res.outcome, minlength=3).tolist(),
            hashlib.blake2s(json.dumps(sweep_digests(res), sort_keys=True)
                            .encode()).hexdigest())


def sweep_phase(dev, trace, path_runs) -> dict:
    """Sweeps on the card, under ``set_sync_debug_mode("error")``, every
    count zeroed before and read after: ``edge_grid`` in ``fused`` over
    the whole quickstart trace (40 static lanes, B1 at [80, 1024], and 8
    autoscaled ones, [16, 1024]); ``routing_grid`` in ``fused`` over the
    whole trace ([192, 256]) and in ``gather`` and ``vmap`` over its
    ``SIM_EVENTS`` head; ``chain_grid`` (18 lanes with an outage, chains
    and per-lane deadlines, windows of ``CHAIN_WINDOW``) in ``fused``,
    monolithic and in chunks of ``CHAIN_CHUNK``; and ``vertical_replay``
    over the whole replay trace in chunks of ``RZ_REPLAY_CHUNK``.  Every
    group goes through the block runner with its lanes as a tensor axis
    (its counts and B1's are checked: one launch a ``fused`` event of a
    group) and every lane is held to ``GOLDEN_SWEEP`` (the replay's to
    ``GOLDEN_RZ``); the edge grid's kiss4096 lane and the routing grid's
    ``size_aware`` lane to ``GOLDEN_FULL``, its head lane to ``GOLDEN``,
    and the chain grid's tight ``slack_aware``/``size_aware`` lanes to
    ``GOLDEN_CHAIN``.  Prints each sweep's lane-events/s, each group's,
    and beside them the path phase's single kiss4096 run (whole trace,
    ``fused``): the ratio is the batching factor."""
    from repro_torch.sim import sweep, trace_fingerprint
    from repro_torch.workloads import (benchmark_chained_trace,
                                       benchmark_replay_trace)
    ctr, replay = benchmark_chained_trace(), benchmark_replay_trace()
    check(trace_fingerprint(replay) == GOLDEN_REPLAY_TRACE,
          "the stored replay trace differs from the one the reference ran")
    check(trace_fingerprint(ctr) == GOLDEN_CHAINED_TRACE,
          "the stored chained trace differs from the one the reference ran")
    head = trace.head(SIM_EVENTS)
    n, nc = len(trace), len(ctr)
    grids = {"edge_grid": edge_grid(), "routing_grid": routing_grid(),
             "chain_grid": chain_grid()}
    runs, groups, lanes_of, fused = {}, {}, {}, 0

    def held(run, grid, tr, spans, mode, golden, chunk=None):
        nonlocal fused
        scns = grids[grid]
        groups[run] = []
        with group_walls(groups[run]):
            res, runs[run] = timed_sweep(
                run, spans, mode, len(scns), len(tr),
                lambda: sweep(tr, list(scns.values()), mode=mode,
                              device=dev, chunk_events=chunk))
        for rec in groups[run]:
            rec["lane_events_per_s"] = rec["lanes"] * len(tr) / rec["wall_s"]
            print(f"  group of {rec['lanes']} lanes x {rec['n_nodes']} "
                  f"nodes: {rec['wall_s']:.2f} s = "
                  f"{rec['lane_events_per_s']:.1f} lane-events/s "
                  f"(capture {rec['capture_s']:.2f} s)", flush=True)
        runs[run]["groups"] = groups[run]
        for name, r in zip(scns, res):
            got = sweep_golden(r)
            want = tuple(GOLDEN_SWEEP[golden][name])
            check(got == want, f"sweep {run} lane {name}: {got} != the JAX "
                  f"reference {want} ({sweep_digests(r)})")
            check(all(np.isfinite(v) for v in r.summary().values()),
                  f"sweep {run} lane {name}: non-finite summary value")
        fused += sum(spans) if mode == "fused" else 0
        lanes_of[run] = dict(zip(scns, res))
        return lanes_of[run]

    def same(res, want, what):
        got = dict(node=digest(res.node), outcome=digest(res.outcome),
                   counts=np.bincount(res.outcome, minlength=3).tolist())
        check(got == want, f"{what}: {got} != the JAX reference {want}")

    torch.cuda.set_sync_debug_mode("error")
    try:
        check(sync_guard_refuses(dev),
              "sync debug mode did not refuse a host sync")
        zero_counts()                       # the sweep path starts here
        total = RunCounts()
        edge = held("edge_grid/fused", "edge_grid", trace,
                    [n] + spans_of(n, ASC_EPOCH), "fused", "edge_grid")
        same(edge["kiss_4g_0.8"], GOLDEN_FULL["kiss4096"],
             "edge_grid kiss_4g_0.8 (kiss4096)")
        routing = held("routing_grid/fused", "routing_grid", trace, [n],
                       "fused", "routing_grid")
        same(routing["size_aware"], GOLDEN_FULL["het16_size_aware"],
             "routing_grid size_aware")
        for mode in ("gather", "vmap"):
            heads = held(f"routing_grid/{mode}/head", "routing_grid", head,
                         [len(head)], mode, "routing_grid_head")
            same(heads["size_aware"], GOLDEN["het16_size_aware"],
                 f"routing_grid size_aware {mode} head")
        for run, chunk in (("chain_grid/fused", None),
                           ("chain_grid/fused/chunked", CHAIN_CHUNK)):
            chain = held(run, "chain_grid", ctr, spans_of(nc, chunk or nc),
                         "fused", "chain_grid", chunk)
            for r in ("slack_aware", "size_aware"):
                got = tel_digests(chain[f"{r}-tight"])
                check(got == GOLDEN_CHAIN[r],
                      f"{run} {r}-tight: {got} != the JAX reference "
                      f"{GOLDEN_CHAIN[r]}")
        vlanes = vertical_replay_lanes()
        nr = len(replay)
        res, runs["vertical_replay/fused/chunked"] = timed_sweep(
            "vertical_replay/fused/chunked",
            spans_of(nr, RZ_REPLAY_CHUNK), "fused", len(vlanes), nr,
            lambda: sweep(replay, list(vlanes.values()), mode="fused",
                          device=dev, chunk_events=RZ_REPLAY_CHUNK))
        for name, r in zip(vlanes, res):
            rz_check(f"vertical_replay lane {name}", r, REPLAY_LANES[name])
        fused += nr
        counts = total.delta()                # ... and ends here
        check(counts["b1_launches"] == fused,
              f"sweeps launched B1 {counts['b1_launches']} times, want "
              f"{fused}")
        sharded = sharded_sweeps(dev, trace, ctr, grids,
                                 lanes_of["chain_grid/fused"], groups)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    single = path_runs["kiss4096/fused/chunked"]["events_per_s"]
    static = groups["edge_grid/fused"][0]
    factor = static["lane_events_per_s"] / single
    print(f"sweeps: every lane matches the JAX reference bitwise; B1 "
          f"launched {counts['b1_launches']} times, once a fused event of "
          f"each group; {counts['captures']} captures in "
          f"{counts['capture_s']:.2f} s; the edge grid's {static['lanes']} "
          f"static lanes {static['lane_events_per_s']:.1f} lane-events/s "
          f"against one kiss4096 simulate's {single:.1f} events/s: "
          f"batching factor {factor:.2f}", flush=True)
    kept = {f"edge_grid/{k}": (edge[k], trace) for k in ORACLE_EDGE_LANES}
    kept[f"chain_grid/{ORACLE_CHAIN_LANE}"] = (
        lanes_of["chain_grid/fused"][ORACLE_CHAIN_LANE], ctr)
    return {"launches": counts["b1_launches"], "counts": counts,
            "runs": runs, "batching_factor": factor,
            "single_events_per_s": single, "oracle_runs": kept,
            "sharded": sharded}


@contextlib.contextmanager
def shards_on(dev, k: int):
    """``k`` devices for a sharded sweep, every shard on ``dev``: the
    engine's device count and its shards' devices patched (one card
    rehearses what ``k`` cards run)."""
    from repro_torch.cluster import engine
    card = torch.device(dev.type, dev.index or 0)
    real = engine._device_count, engine._lane_devices
    engine._device_count = lambda device=None: k
    engine._lane_devices = lambda n, device: [card] * n
    try:
        yield
    finally:
        engine._device_count, engine._lane_devices = real


def sharded_sweeps(dev, trace, ctr, grids, base, groups) -> dict:
    """Sharded sweeps (``devices=k``) on the card, inside the sweep
    phase's ``set_sync_debug_mode("error")``, every count zeroed before
    and read after.  The rehearsal patches the device count and the
    shards' devices so that ``k`` shards land on ``dev`` one after
    another, each through its block runner: the chain grid in ``fused``
    at ``SHARD_CHAIN`` shards and the edge grid's autoscaled lanes at
    ``SHARD_ASC``; B1 must launch once a ``fused`` event of each shard,
    and the shards of one width capture once.  Then, unpatched,
    ``devices=1`` and ``"all"`` must equal the unsharded chain grid
    (``base``, the sweep phase's results) and ``devices=count+1`` must
    raise before any launch.  With two cards or more, both grids run
    across the real cards at once.  Every lane is held to
    ``GOLDEN_SWEEP`` (the tight chain lanes also to ``GOLDEN_CHAIN``)."""
    from repro_torch.sim import sweep
    n, nc = len(trace), len(ctr)
    chain = grids["chain_grid"]
    asc = {k: v for k, v in grids["edge_grid"].items()
           if k.startswith("adaptive_")}
    cards = torch.cuda.device_count()
    runs, fused = {}, 0

    def run(what, scns, tr, golden, k, spans, devices, captures=None):
        nonlocal fused
        res, runs[what] = timed_sweep(
            what, spans * k, "fused", len(scns), len(tr),
            lambda: sweep(tr, list(scns.values()), mode="fused",
                          device=dev, devices=devices))
        if captures is not None:
            check(runs[what]["captures"] == captures,
                  f"{what}: {runs[what]['captures']} captures, want "
                  f"{captures} (one a shard shape)")
        got = dict(zip(scns, res))
        for name, r in got.items():
            want = tuple(GOLDEN_SWEEP[golden][name])
            check(sweep_golden(r) == want,
                  f"{what} lane {name}: {sweep_golden(r)} != the JAX "
                  f"reference {want}")
            check(r.run_info["devices"] == k,
                  f"{what} lane {name}: run_info devices "
                  f"{r.run_info['devices']} != {k}")
        if golden == "chain_grid":
            for r in ("slack_aware", "size_aware"):
                tel = tel_digests(got[f"{r}-tight"])
                check(tel == GOLDEN_CHAIN[r], f"{what} {r}-tight: {tel} != "
                      f"the JAX reference {GOLDEN_CHAIN[r]}")
        fused += k * sum(spans)
        return got

    zero_counts()                       # the sharded path starts here
    total = RunCounts()
    with shards_on(dev, SHARD_CHAIN):
        run(f"chain_grid/fused/k{SHARD_CHAIN}", chain, ctr, "chain_grid",
            SHARD_CHAIN, [nc], SHARD_CHAIN, captures=1)
    with shards_on(dev, SHARD_ASC):
        run(f"edge_grid_adaptive/fused/k{SHARD_ASC}", asc, trace,
            "edge_grid", SHARD_ASC, spans_of(n, ASC_EPOCH), SHARD_ASC,
            captures=1)
    for devices in (1, "all"):
        got = run(f"chain_grid/fused/devices={devices}", chain, ctr,
                  "chain_grid", cards if devices == "all" else 1, [nc],
                  devices)
        for name, r in got.items():
            check(sweep_digests(r) == sweep_digests(base[name]),
                  f"devices={devices} lane {name} differs from the "
                  "unsharded sweep")
    before = RunCounts()
    try:
        sweep(ctr, list(chain.values()), mode="fused", device=dev,
              devices=cards + 1)
        refused = False
    except ValueError as e:
        refused = "exceeds" in str(e)
    moved = before.delta()
    check(refused, f"devices={cards + 1} was not refused with 'exceeds'")
    check(moved["b1_launches"] == 0 and moved["blocks"] == 0
          and moved["captures"] == 0,
          f"devices={cards + 1} ran before it was refused: {moved}")
    if cards >= 2:
        run("chain_grid/fused/cards", chain, ctr, "chain_grid", cards,
            [nc], "all")
        run("edge_grid_adaptive/fused/cards", asc, trace, "edge_grid",
            cards, spans_of(n, ASC_EPOCH), "all")
        for what, group in (("chain_grid/fused/cards",
                             groups["chain_grid/fused"][0]),
                            ("edge_grid_adaptive/fused/cards",
                             groups["edge_grid/fused"][1])):
            print(f"  {what}: {runs[what]['lane_events_per_s']:.1f} "
                  f"lane-events/s across {cards} cards against the "
                  f"unsharded group's {group['lane_events_per_s']:.1f}",
                  flush=True)
    else:
        print(f"sharded sweeps: {cards} card: the run across real cards "
              "was not made", flush=True)
    counts = total.delta()                # ... and ends here
    check(counts["b1_launches"] == fused,
          f"sharded sweeps launched B1 {counts['b1_launches']} times, "
          f"want {fused} (shards x fused events)")
    print(f"sharded sweeps: every lane matches the JAX reference bitwise; "
          f"B1 launched {counts['b1_launches']} times, once a fused event "
          f"of each shard; {counts['captures']} captures", flush=True)
    return {"launches": counts["b1_launches"], "counts": counts,
            "runs": runs, "cards": cards}


#: The lane counts of the busy phase's sweep flavour: the edge grid's
#: first L static lanes.
BUSY_LANES = (1, 8, 40)


def busy_phase(dev, trace) -> dict:
    """Device busy share and device records an event over two graph
    replays (the first ``2 * BLOCK_EVENTS`` events) of the kiss scenario,
    for the static runner, the autoscaled one (an epoch of
    ``ASC_EPOCH`` events, so the window holds no re-split: the per-event
    cost of the live mask and the pressure) and the resize one
    (``Resize("fair_share", RZ_MIN_MB)``: the shrink pass and the
    accumulators an event), of the ``slack_aware``
    chain scenario on the chain benchmark's trace (telemetry and chains
    on, the runner with failures), and of a sweep of the edge grid's
    first L static lanes for each L of ``BUSY_LANES`` (one group, the
    lanes a tensor axis), each in ``gather`` and ``fused``:
    summed device time of every kernel and copy the profiler
    saw over the host wall time of the run, and the count of those
    device records over the events.  The window is short because the
    profiler's post-processing costs ~0.1 s an event.  In ``fused`` the
    profile must also hold B1's ``evict_place_kernel`` at most once an
    event: the launches the runner adds per replay, seen on the device.
    A session that comes back with no kernel record at all (PERF.md §7)
    is taken again, four in all, as ``kernel_ms`` does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cluster.graphs import BLOCK_EVENTS
    from repro_torch.sim import Autoscale, Resize, simulate, sweep
    from repro_torch.workloads import benchmark_chained_trace
    n_events = 2 * BLOCK_EVENTS
    head, kiss = trace.head(n_events), scenarios()["kiss4096"]

    def one(scn):
        return lambda tr, mode: simulate(scn, tr, mode=mode, device=dev)
    flavours = {"static": (one(kiss), head), "autoscaled": (one(
        dataclasses.replace(kiss, autoscale=Autoscale(
            epoch_events=ASC_EPOCH))), head),
        "resize": (one(dataclasses.replace(
            kiss, resize=Resize("fair_share", RZ_MIN_MB))), head),
        "telemetry+chains": (one(chain_scenarios()["slack_aware"]),
                             benchmark_chained_trace().head(n_events))}
    static = list(edge_grid().values())[:len(EDGE_MEMS) * len(EDGE_SPLITS)]
    for lanes in BUSY_LANES:
        flavours[f"sweep L={lanes}"] = (
            lambda tr, mode, scns=static[:lanes]: sweep(
                tr, scns, mode=mode, device=dev), head)
    out = {}

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0)
    for flavour, (run, head) in flavours.items():
        for mode in ("gather", "fused"):
            run(head.head(50), mode)                           # warm-up
            for attempt in range(4):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    run(head, mode)
                    wall = time.perf_counter() - t0
                events = prof.key_averages()
                if any(dev_us(e) > 0 for e in events):
                    break
            what = f"busy {flavour} {mode}"
            b1 = sum(e.count for e in events
                     if any(n in e.key for n in POOL_KERNELS))
            if mode == "fused":
                check(1 <= b1 <= n_events,
                      f"{what}: {b1} evict_place_kernel records over "
                      f"{n_events} events: want 1 to {n_events}")
            else:
                check(b1 == 0, f"{what}: {b1} evict_place_kernel records")
            records = sum(e.count for e in events
                          if e.device_type == DeviceType.CUDA)
            top = sorted(events, key=dev_us, reverse=True)[:3]
            busy = device_s(events) / wall
            out[f"{flavour}/{mode}"] = dict(
                busy=busy, device_records_per_event=records / n_events,
                b1_records=b1)
            print(f"{what}: device busy {100 * busy:.1f}% of {wall:.2f} s "
                  f"wall over {n_events} events; {records / n_events:.2f} "
                  f"device records an event; {b1} evict_place_kernel "
                  "records; top device time: "
                  + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.1f} ms"
                              for e in top), flush=True)
    for mode in ("gather", "fused"):
        rec = {lanes: out[f"sweep L={lanes}/{mode}"]
               for lanes in BUSY_LANES}
        base = rec[1]["device_records_per_event"]
        for r in rec.values():
            r["records_vs_one_lane"] = r["device_records_per_event"] / base
        print(f"busy sweep {mode}: device records an event against one "
              "lane's: " + ", ".join(
                  f"L = {lanes} {r['records_vs_one_lane']:.3f}"
                  for lanes, r in rec.items()), flush=True)
    return out


#: The card runs of earlier phases that the oracle phase holds to the
#: numpy oracle: two lanes of the sweep phase's edge grid, one lane of its
#: chain grid (and, by their phases, the failure phase's ``fused`` run and
#: the autoscale phase's ``fused`` kiss4096).
ORACLE_EDGE_LANES = ("kiss_2g_0.9", "baseline_3g")
ORACLE_CHAIN_LANE = "cost_model-tight"
#: The events of the traces the oracle phase draws on this host: 128
#: blocks of 32, so no event runs in a runner's eager remainder.
ORACLE_EVENTS = 4096
#: The telemetry window of the replay sweep's hybrid lane.
ORACLE_WINDOW = 512


def same_trace(a, b) -> bool:
    """Two traces equal field for field, dtypes and bytes included."""
    return all((x is None and y is None) or (
        x is not None and y is not None and x.dtype == y.dtype
        and x.shape == y.shape and x.tobytes() == y.tobytes())
        for x, y in zip(a, b))


def same_result(card, host, what: str) -> None:
    """``card`` (the torch engine's ``Result``) equals ``host`` (the
    oracle's) bitwise: per-event, per-epoch and failure arrays, the
    latencies, the vertical totals, every window and per-chain array and
    every ``summary()`` key."""
    arrays = {f: getattr(card, f) for f in (
        "node", "outcome", "per_node", "fracs", "active", "invalidated",
        "node_up", "epoch_t")}
    arrays["latencies"] = card.raw.latencies
    want = {f: getattr(host, f) for f in arrays if f != "latencies"}
    want["latencies"] = host.raw.latencies
    for k, v in (card.vertical or {}).items():
        arrays[f"vertical.{k}"] = v
    for k, v in (host.vertical or {}).items():
        want[f"vertical.{k}"] = v
    for owner in ("telemetry", "chains"):
        for side, res in ((arrays, card), (want, host)):
            obj = getattr(res, owner)
            for f in (dataclasses.fields(obj) if obj is not None else ()):
                v = getattr(obj, f.name)
                if isinstance(v, np.ndarray):
                    side[f"{owner}.{f.name}"] = v
    check(arrays.keys() == want.keys(),
          f"{what}: arrays {sorted(arrays)} != the oracle's {sorted(want)}")
    for k, a in arrays.items():
        b = want[k]
        check((a is None) == (b is None), f"{what}: {k} present on one side")
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            check(a.dtype == b.dtype and a.shape == b.shape
                  and a.tobytes() == b.tobytes(),
                  f"{what}: {k} differs from the numpy oracle's")
    check(card.summary() == host.summary(),
          f"{what}: summary differs from the numpy oracle's")


def oracle_phase(dev, trace, kept: dict) -> dict:
    """The numpy oracle (``engine="ref"``) on this host, against the card.

    1. Ingest: the vertical benchmark's stored Azure tables written as
       the public CSVs and read back by ``load_azure_trace``, which must
       equal ``trace_from_tables`` of the same tables drawn here and the
       stored replay trace; ``analyze`` of it printed.
    2. The card runs ``kept`` from earlier phases (edge-grid and
       chain-grid lanes, the failure run, the autoscaled kiss4096), each
       equal to ``sweep(..., engine="ref")`` of its scenario, bitwise.
    3. Traces drawn here, with no JAX golden: ``bursty_trace(seed=0)``'s
       and the ingested replay's first ``ORACLE_EVENTS``, each through one
       ``fused`` sweep on the card (under ``set_sync_debug_mode("error")``,
       every count zeroed before and read after, B1 once a ``fused``
       event of a group), each lane equal to the oracle's.
    Prints the oracle's host events/s (host time: numpy on the CPU) and
    the card's lane-events/s."""
    import tempfile
    from repro_torch.core.analyzer import analyze
    from repro_torch.sim import Scenario, sweep
    from repro_torch.workloads import (benchmark_replay_tables,
                                       benchmark_replay_trace, bursty_trace,
                                       load_azure_trace, trace_from_tables,
                                       write_azure_csvs)
    tables = benchmark_replay_tables()
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        ingested = load_azure_trace(*write_azure_csvs(tables, d))
    ingest_s = time.perf_counter() - t0
    check(same_trace(ingested, trace_from_tables(tables)),
          "ingest (a): load_azure_trace of the written CSVs differs from "
          "trace_from_tables of the same tables")
    check(same_trace(ingested, benchmark_replay_trace()),
          "ingest (b): the ingested trace differs from the stored replay "
          "trace")
    prof = analyze(ingested)
    print(f"oracle ingest: {tables.n_functions} functions x "
          f"{tables.n_minutes} minutes -> CSVs -> {len(ingested)} events "
          f"in {ingest_s:.2f} s, equal to trace_from_tables here and to the "
          f"stored replay trace; analyze: {prof.small_count} small / "
          f"{prof.large_count} large, invocation ratio "
          f"{prof.invocation_ratio:.3f}, suggested small_frac "
          f"{prof.suggested_small_frac:.3f}", flush=True)
    host = {"events": 0, "s": 0.0}

    def oracle(tr, scns):
        t1 = time.perf_counter()
        out = sweep(tr, scns, engine="ref")
        host["s"] += time.perf_counter() - t1
        host["events"] += len(tr) * len(scns)
        return out

    by_trace: dict = {}
    for name, (res, tr) in kept.items():
        by_trace.setdefault(id(tr), (tr, []))[1].append((name, res))
    for tr, runs in by_trace.values():
        for (name, res), want in zip(runs, oracle(
                tr, [res.scenario for _, res in runs])):
            same_result(res, want, f"oracle {name}")
    print(f"oracle: the card's {', '.join(kept)} equal the numpy oracle "
          "bitwise", flush=True)

    n = ORACLE_EVENTS
    bursty = bursty_trace(seed=0).head(n)
    replay = ingested.head(n)
    check(len(bursty) == len(replay) == n, "oracle: short traces")
    grids = {
        "bursty": (bursty, [Scenario.kiss(4096.0), Scenario.baseline(4096.0),
                            Scenario.kiss(2048.0, small_frac=0.7)], [n]),
        "replay": (replay, [dataclasses.replace(
            vertical_lanes()["hybrid"], telemetry=ORACLE_WINDOW),
            scenarios()["het16_size_aware"]], [n, n])}
    runs, cards = {}, {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        check(sync_guard_refuses(dev),
              "sync debug mode did not refuse a host sync")
        zero_counts()                      # the oracle path starts here
        total = RunCounts()
        for name, (tr, scns, spans) in grids.items():
            cards[name], runs[name] = timed_sweep(
                f"oracle {name}/fused", spans, "fused", len(scns), n,
                lambda: sweep(tr, scns, mode="fused", device=dev))
        counts = total.delta()                # ... and ends here
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fused = sum(sum(spans) for _, _, spans in grids.values())
    check(counts["b1_launches"] == fused,
          f"oracle phase launched B1 {counts['b1_launches']} times, want "
          f"{fused}")
    for name, (tr, scns, _) in grids.items():
        for i, (res, want) in enumerate(zip(cards[name], oracle(tr, scns))):
            same_result(res, want, f"oracle {name} lane {i}")
            check(all(np.isfinite(v) for v in res.summary().values()),
                  f"oracle {name} lane {i}: non-finite summary value")
    rate = host["events"] / host["s"]
    print(f"oracle: the card's sweeps on traces drawn here (bursty_trace "
          f"and the ingested replay, {n} events each) equal the numpy "
          f"oracle bitwise; the oracle ran {host['events']} events in "
          f"{host['s']:.2f} s of host time = {rate:.1f} events/s (numpy on "
          f"the host CPU, not the device); B1 launched "
          f"{counts['b1_launches']} times", flush=True)
    return {"launches": counts["b1_launches"], "counts": counts,
            "runs": runs, "ingest_s": ingest_s,
            "host_events": host["events"], "host_s": host["s"],
            "host_events_per_s": rate,
            "analyze": {"small": prof.small_count,
                        "large": prof.large_count,
                        "invocation_ratio": prof.invocation_ratio,
                        "suggested_small_frac": prof.suggested_small_frac}}


#: ``launch.serve.default_registry(6)``'s models at full width, in its
#: order, but qwen2.5-32b, whose ~65 GB of bf16 weights cannot share the
#: card with the others.
SERVE_MODELS = ("starcoder2-3b", "rwkv6-7b", "zamba2-1.2b", "glm4-9b",
                "granite-moe-1b-a400m")
SERVE_REQUESTS = 16
#: The models of the eviction phase.
EVICT_MODELS = ("starcoder2-3b", "glm4-9b")
SERVE_CKW = dict(max_batch=2, max_len=4096)
#: The KissServer's budget: the threshold puts starcoder2-3b, zamba2-1.2b
#: and granite-moe-1b-a400m in the small class and rwkv6-7b and glm4-9b
#: in the large one, and by the f32 estimates each pool holds all of its
#: models (12,722 + 6,186 + 5,540 = 24,449 MB of 25,920; 30,066 + 37,599
#: = 67,665 MB of 70,080; pinned by tests/test_torch_serving.py).
SERVE_BUDGET = dict(total_mb=96_000, small_frac=0.27, threshold_mb=20_000)
#: How far device memory may sit from the resident model's weights after
#: an eviction: 64 MB (cuBLAS workspace, small buffers) plus 1 MiB a
#: weight tensor, since the caching allocator does not split a block it
#: reuses when less than 1 MiB would remain, and counts that remainder
#: as allocated.
EVICT_MARGIN_MB = 64.0
BLOCK_SLACK_MB = 1.048576
#: Logits of the bf16 kernel path against the f32 plain forward: the
#: relative L2 error of each position's logits vector.  bf16 keeps 8
#: significant bits (a rounding error of 2^-9 each step); over 30-40
#: layers of bf16 weights and activations the logits drift by 1-2%
#: (1.15-1.24% for starcoder2-3b and 1.80-1.90% for glm4-9b in this
#: script's first full run, NVIDIA H100 80GB HBM3, 700.00 W).  5% leaves
#: room for that, and the control - the same forward without the window
#: the kernel path applies - is off by 59-79%, so a lost or misplaced
#: window fails by 10x.  The kernels take no fp16.
LOGITS_TOL = 0.05
#: The same bound for rwkv6-7b.  Its 32 RWKV6 blocks drift further in
#: bf16 than attention blocks do, kernels or not: the bf16 *plain*
#: forward (no kernel of the port) is itself off the f32 forward by
#: 8.29-9.37%, and the kernel path by 8.15-9.08% (``plain_bf16_rel_l2``
#: and ``rel_l2`` in the logits line, NVIDIA H100 80GB HBM3, 700.00 W).
#: 12% leaves room for that, and the control that zeroes the recurrent
#: state before each decode step is off by 128-131%, so a state that is
#: not carried fails by 10x.  zamba2-1.2b keeps ``LOGITS_TOL``: 2.65-2.90%
#: (its bf16 plain forward 2.55-2.95%), the control 51-61%.
RWKV_LOGITS_TOL = 0.12


def kernel_counts(registry, pre, dec) -> dict:
    """Launches of each kernel that ``pre`` prefills and ``dec`` decode
    steps per model need, layer kind by layer kind: B3 once an attention
    position a prefill, B2 once a decode step; B4 once a Mamba layer a
    prefill (its decode is the plain single-token update); B5 once an
    RWKV layer a prefill and a decode step."""
    out = dict(flash_attention=0, decode_attention=0, ssm_scan=0, wkv6=0)
    for m, cfg in registry.items():
        kinds = cfg.layer_kinds()
        out["flash_attention"] += kinds.count("attn") * pre[m]
        out["decode_attention"] += kinds.count("attn") * dec[m]
        out["ssm_scan"] += kinds.count("mamba") * pre[m]
        out["wkv6"] += kinds.count("rwkv") * (pre[m] + dec[m])
    return out


def expected_launches(registry, reqs, max_batch: int, results):
    """Prefills and decode steps per model that the requests ask for, as
    ``launch.serve.run`` batches them: a drain every ``max_batch``
    requests, one ``submit`` per model in a drain; a submit that is not
    dropped prefills once and decodes ``n_new - 1`` times, and a cold
    start adds the container's warm-up (one prefill, one decode)."""
    pre = {m: 0 for m in registry}
    dec = {m: 0 for m in registry}
    for i in range(0, len(reqs), max_batch):
        chunk = reqs[i:i + max_batch]
        for m in dict.fromkeys(r.model_id for r in chunk):
            group = [r for r in chunk if r.model_id == m]
            status = results[id(group[0])]
            if status == "drop":
                continue
            warm_up = status == "miss"
            pre[m] += 1 + warm_up
            dec[m] += max(r.n_new for r in group) - 1 + warm_up
    return pre, dec


def serving_phase(dev) -> dict:
    """Full-width starcoder2-3b, rwkv6-7b, zamba2-1.2b, glm4-9b and
    granite-moe-1b-a400m behind one KissServer: ``SERVE_REQUESTS``
    requests through ``launch.serve.run``, with B2-B5's counts zeroed just
    before and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda
    from repro_torch.launch.serve import (default_registry, run,
                                          synthesize_requests)
    from repro_torch.serving import KissServer
    six = list(default_registry())
    check(tuple(m for m in six if m != "qwen2.5-32b") == SERVE_MODELS,
          f"default_registry() is {six}")
    registry = {a: get_config(a) for a in SERVE_MODELS}
    server = KissServer(registry, **SERVE_BUDGET,
                        container_kwargs=dict(SERVE_CKW, device=dev))
    check([server.size_class(m) for m in SERVE_MODELS] == [0, 1, 0, 1, 0],
          "starcoder2-3b, zamba2-1.2b and granite-moe-1b-a400m must be "
          "small, rwkv6-7b and glm4-9b large")
    reqs = synthesize_requests(registry, SERVE_REQUESTS, seed=0)
    asked = {m: sum(r.model_id == m for r in reqs) for m in SERVE_MODELS}
    check(min(asked.values()) > 0, f"a model got no request: {asked}")
    kernels = dict(flash_attention=flash_attention_cuda,
                   decode_attention=decode_attention_cuda,
                   ssm_scan=ssm_scan_cuda, wkv6=wkv6_cuda)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():              # the serving path starts here
        k.launches = 0
    t0 = time.perf_counter()
    stats = run(server, registry, reqs)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    torch.cuda.synchronize()                # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(r.result is not None for r in reqs),
          "a request went unanswered")
    statuses = [r.result.status for r in reqs]
    check("drop" not in statuses, f"dropped requests: {statuses}")
    for r in reqs:
        t = r.result.tokens
        check(t.shape == (1, r.n_new) and ((t >= 0) & (
            t < registry[r.model_id].vocab_size)).all(),
            f"{r.model_id}: tokens {t}")
    pre, dec = expected_launches(registry, reqs, 2,
                                 {id(r): r.result.status for r in reqs})
    want = kernel_counts(registry, pre, dec)
    check(launches == want and min(launches.values()) > 0,
          f"kernel launches {launches} != layers x requests {want}")
    print(f"serve KissServer {SERVE_BUDGET} "
          f"on {dev}: {len(reqs)} requests ({asked}) in {wall:.2f} s, "
          f"statuses "
          f"{ {k: statuses.count(k) for k in ('hit', 'miss', 'drop')} }, "
          f"prefills {pre}, decode steps {dec}; launches {launches} == "
          f"layers of each kind x requests; peak {peak_gb:.2f} GB",
          flush=True)
    for c, name in ((0, "small"), (1, "large")):
        m = server.stats.cls(c)
        print(f"serve ClassMetrics {name}: hits {m.hits}, misses "
              f"{m.misses}, drops {m.drops}, cold-start "
              f"{m.cold_start_pct:.1f}%", flush=True)
    models = {}
    for m in SERVE_MODELS:
        c = server.containers[m]
        warm = [r.result.latency_s for r in reqs
                if r.model_id == m and r.result.status == "hit"]
        prompt = np.zeros((2, 12), np.int32)
        steps = min(64, c.max_len - c.prefill_len - 1)
        c.generate(prompt, 2)
        times = {}
        for n_new in (1, 1 + steps):
            t0 = time.perf_counter()
            c.generate(prompt, n_new)
            times[n_new] = time.perf_counter() - t0
        tok_s = c.max_batch * steps / (times[1 + steps] - times[1])
        models[m] = dict(cold_start_s=c.cold_start_s,
                         mean_warm_ms=1e3 * float(np.mean(warm))
                         if warm else None, n_warm=len(warm),
                         decode_tokens_s=tok_s, size_mb=c.size_mb)
        print(f"serve {m}: cold start {c.cold_start_s:.2f} s, mean warm "
              f"{models[m]['mean_warm_ms']} ms over {len(warm)} hits, "
              f"decode {tok_s:.1f} tokens/s at batch 2, size "
              f"{c.size_mb:.1f} MB", flush=True)
    busy = {m: serving_busy(server.containers[m]) for m in SERVE_MODELS}
    sizes = {m: server.size_mb(m) for m in SERVE_MODELS}
    return dict(stats=stats, wall_s=wall, launches=launches,
                expected=want, models=models, sizes=sizes,
                peak_gb=peak_gb, busy=busy)


def serving_busy(container, n_new: int = 9) -> dict:
    """Device busy share of one warm ``generate`` (a prefill and
    ``n_new - 1`` decode steps at batch 2): summed device time of every
    kernel and copy the profiler saw, over the host wall time."""
    from torch.profiler import ProfilerActivity, profile
    prompt = np.zeros((container.max_batch, 12), np.int32)
    container.generate(prompt, n_new)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        container.generate(prompt, n_new)
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0)
    events = prof.key_averages()
    top = sorted(events, key=dev_us, reverse=True)[:4]
    share = device_s(events) / wall
    print(f"serve busy {container.cfg.name}: device busy "
          f"{100 * share:.1f}% of {wall * 1e3:.1f} ms wall for a prefill "
          f"and {n_new - 1} decode steps; top device time: " + "; ".join(
              f"{e.key[:40]} {dev_us(e) / 1e3:.2f} ms" for e in top),
          flush=True)
    return dict(share=share, wall_s=wall,
                top=[(e.key, dev_us(e) / 1e3) for e in top])


def eviction_phase(dev, sizes: dict) -> dict:
    """A UnifiedServer that holds one model at a time; every request
    after the first evicts the other model, and the memory allocated on
    the device must fall to the resident model's weights.  The server
    starts from the sizes the serving phase measured: with the f32
    estimates only (12,722 and 37,599 MB) a pool that takes glm4-9b's
    first instantiation would, once the sizes refine to the real bf16
    footprints, hold both models."""
    from repro_torch.configs import get_config
    from repro_torch.serving import UnifiedServer, pytree_mb
    registry = {a: get_config(a) for a in EVICT_MODELS}
    sizes = {m: sizes[m] for m in EVICT_MODELS}
    total = max(sizes.values()) + min(sizes.values()) / 2
    check(max(sizes.values()) <= total < sum(sizes.values()),
          f"sizes {sizes} do not make a one-model pool of {total} MB")
    server = UnifiedServer(registry, total_mb=total,
                           threshold_mb=SERVE_BUDGET["threshold_mb"],
                           container_kwargs=dict(SERVE_CKW, device=dev))
    server._size_cache.update(sizes)
    gc.collect()
    base = torch.cuda.memory_allocated()
    prompt = np.zeros((1, 12), np.int32)
    rows = []
    for i, m in enumerate(EVICT_MODELS * 3):
        res = server.submit(m, prompt, n_new=2, now=float(i))
        victims = [server._id_to_model(v.func_id)
                   for v in server.pool.last_victims]
        check(res.status == "miss", f"request {i} ({m}): {res.status}")
        check(victims == ([] if i == 0 else [EVICT_MODELS[(i + 1) % 2]]),
              f"request {i} ({m}) evicted {victims}")
        check(list(server.containers) == [m], f"resident: "
              f"{list(server.containers)}")
        alloc_mb = (torch.cuda.memory_allocated() - base) / 1e6
        weights_mb = pytree_mb(server.containers[m].params)
        margin = EVICT_MARGIN_MB + BLOCK_SLACK_MB * n_tensors(
            server.containers[m].params)
        check(abs(alloc_mb - weights_mb) <= margin,
              f"after request {i} ({m}, evicted {victims}) {alloc_mb:.1f} "
              f"MB allocated, the resident weights are {weights_mb:.1f} MB "
              f"(margin {margin:.1f} MB)")
        rows.append(dict(model=m, evicted=victims, allocated_mb=alloc_mb,
                         weights_mb=weights_mb, margin_mb=margin))
        print(f"evict request {i}: {m} cold, evicted {victims}; device "
              f"memory allocated {alloc_mb:.1f} MB, resident weights "
              f"{weights_mb:.1f} MB (margin {margin:.1f} MB)", flush=True)
    del server
    return {"rows": rows}


def n_tensors(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_tensors(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_tensors(v) for v in tree)
    return 1


@contextlib.contextmanager
def plain_kernels():
    """Every kernel entry point of ``kernels.ops`` replaced by its plain
    version while the block runs (the model modules call them through
    ``ops``), so a forward on the card runs no kernel of the port."""
    from repro_torch.kernels import (decode_attention, flash_attention, ops,
                                     ssm_scan, wkv6)
    names = ("flash_attention", "decode_attention", "ssm_scan", "wkv6")
    saved = [getattr(ops, n) for n in names]
    for n, mod in zip(names, (flash_attention, decode_attention, ssm_scan,
                              wkv6)):
        setattr(ops, n, getattr(mod, f"{n}_plain"))
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(ops, n, fn)


def cast_f32(tree):
    """A params tree (dicts, lists, ``None``) with every tensor in f32."""
    if isinstance(tree, dict):
        return {k: cast_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_f32(v) for v in tree]
    return None if tree is None else tree.float()


def plain_forward(cfg, params, tokens, dtype=torch.float32, *,
                  positions=None, patches=None):
    """Logits f32 [B, S, V] of the whole sequence with no cache: the
    port's own blocks with every kernel replaced by its plain version, in
    f32 (every weight cast to f32 a layer at a time, the hybrid's shared
    block once) or, with ``dtype=torch.bfloat16``, with the weights as
    they are.  ``positions`` default to 0..S-1; ``patches`` (embeddings,
    positions) are spliced in as a VLM's are."""
    from repro_torch.models import transformer as T

    def cast(tree):
        return cast_f32(tree) if dtype == torch.float32 else tree
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32,
                       device=tokens.device)[None].expand(b, s) \
        if positions is None else positions
    batch = {"tokens": tokens, "positions": pos}
    if patches is not None:
        batch["patch_embeds"], batch["patch_positions"] = patches
    cfg_x = dataclasses.replace(cfg, dtype=str(dtype).removeprefix("torch."))
    x = T._embed_inputs(cfg_x, params, batch)
    shared = cast(params["shared_attn"]) if "shared_attn" in params \
        else None
    with plain_kernels():
        for i, kind in enumerate(cfg.layer_kinds()):
            if kind == "mamba":
                x, _ = T._mamba_block(cfg, cast(params["layers"][i]), x,
                                      mode="train")
            elif kind == "rwkv":
                x, _ = T._rwkv_block(cfg, cast(params["layers"][i]), x)
            else:
                lp = shared if shared is not None \
                    else cast(params["layers"][i])
                x, _, _ = T._attn_block(cfg, lp, x, pos, mode="train")
    head = {k: cast(params[k]) for k in (
        "final_norm", "embed" if cfg.tie_embeddings else "lm_head")}
    return T._head(cfg, head, x)


def reset_state(cache):
    """The cache with its recurrent state zeroed (an ``SSMCache``'s conv
    history and h, an ``RWKVCache``'s shifts and WKV state); a
    ``KVCache`` as it is."""
    if hasattr(cache, "slot_pos"):
        return cache
    return type(cache)(*(torch.zeros_like(t) for t in cache))


def decode_with_state_reset(c, prompt, tokens):
    """Logits f32 [n_new, V] of the container's generate of ``prompt``
    forced through ``tokens`` (its own greedy tokens), with every
    recurrent state zeroed before each decode step."""
    from repro_torch.models import decode_step, prefill
    s = c.prefill_len
    toks = np.zeros((c.max_batch, s), np.int32)
    toks[:1, :prompt.shape[1]] = prompt
    logits, caches = prefill(c.cfg, c.params,
                             c._batch(torch.from_numpy(toks).to(c.device), 0),
                             cache_len=c.max_len)
    steps = [logits[:1, -1]]
    for i in range(tokens.shape[1] - 1):
        caches = [reset_state(x) for x in caches]
        nxt = torch.full((c.max_batch, 1), int(tokens[0, i]),
                         dtype=torch.int32, device=c.device)
        logits, caches = decode_step(c.cfg, c.params, c._batch(nxt, s + i),
                                     caches)
        steps.append(logits[:1, -1])
    return torch.cat(steps)


def rel_errors(got, want) -> list[float]:
    """Per position: ||got - want|| / ||want|| over the vocabulary."""
    return [float((g - w).norm() / w.norm()) for g, w in zip(got, want)]


def path_logits(cfg, params, first, step_batch, n_new, cache_len,
                forced=None):
    """A prefill of the batch ``first``, then ``n_new - 1`` decode steps
    (``step_batch(i, tokens [B, 1])`` gives step i's batch), feeding each
    step's greedy tokens or ``forced[:, i]``: (the tokens fed [B,
    n_new - 1], logits f32 [B, n_new, V]).  An MoE layer routes each
    call's tokens as one group, with its capacity, so an MoE model's
    logits are held to a plain run of these same calls: a whole-sequence
    forward would group and drop tokens otherwise."""
    from repro_torch.models import decode_step, prefill
    logits, caches = prefill(cfg, params, first, cache_len=cache_len)
    steps, fed = [logits[:, -1]], []
    for i in range(n_new - 1):
        nxt = steps[-1].argmax(-1) if forced is None else forced[:, i]
        fed.append(nxt.to(torch.int32)[:, None])
        logits, caches = decode_step(cfg, params, step_batch(i, fed[-1]),
                                     caches)
        steps.append(logits[:, -1])
    return torch.cat(fed, 1), torch.stack(steps, 1)


def logits_row(name, errs, tol, control=None, control_errs=None,
               **extra) -> dict:
    """Print and check one logits comparison: every relative L2 error
    within ``tol`` and, with a control, every one of the control's
    beyond it."""
    row = dict(rel_l2=errs, tolerance=tol, control=control, **extra)
    if control:
        row["control_rel_l2"] = control_errs
    print(f"logits {name}: relative L2 per position "
          f"{[round(e, 5) for e in errs]} (tolerance {tol})"
          + "".join(f"; {k} {[round(e, 5) for e in v]}"
                    if isinstance(v, list) else f"; {k} {v:.4f}"
                    for k, v in extra.items())
          + (f"; control ({control}) "
             f"{[round(e, 4) for e in control_errs]}" if control else ""),
          flush=True)
    check(max(errs) <= tol, f"{name}: logits off by {max(errs):.4f} > {tol}")
    if control:
        check(min(control_errs) > tol, f"{name}: the control ({control}) "
              f"is within {tol} of the reference")
    return row


def moe_logits(c, prompt, n_new, control: dict,
               ref_dtype=torch.float32) -> dict:
    """An MoE container's greedy generate (bf16, kernels) against the same
    prefill and decode steps in plain torch (weights in ``ref_dtype``,
    every kernel plain), both rows of the batch, forced through the
    kernel path's tokens; the control is that plain path with the config
    changed by ``control`` (a ``dataclasses.replace`` of it)."""
    s = c.prefill_len
    toks = np.zeros((c.max_batch, s), np.int32)
    toks[:prompt.shape[0], :prompt.shape[1]] = prompt
    first = c._batch(torch.from_numpy(toks).to(c.device), 0)

    def step(i, t):
        return c._batch(t, s + i)
    with torch.no_grad():
        fed, got = path_logits(c.cfg, c.params, first, step, n_new,
                               c.max_len)
        params = c.params if ref_dtype == torch.bfloat16 \
            else cast_f32(c.params)
        cfg = dataclasses.replace(c.cfg, dtype=str(ref_dtype)
                                  .removeprefix("torch."))
        with plain_kernels():
            _, want = path_logits(cfg, params, first, step, n_new,
                                  c.max_len, fed)
            _, one = path_logits(dataclasses.replace(cfg, **control),
                                 params, first, step, n_new, c.max_len, fed)
            plain16 = want if ref_dtype == torch.bfloat16 else path_logits(
                c.cfg, c.params, first, step, n_new, c.max_len, fed)[1]
        del params
    got, want, one, plain16 = (t.flatten(0, 1)
                               for t in (got, want, one, plain16))
    return dict(errs=rel_errors(got, want),
                control_errs=rel_errors(got, one),
                plain_bf16_rel_l2=rel_errors(plain16, want),
                max_abs_err=float((got - want).abs().max()),
                logit_scale=float(want.abs().max()))


def logits_phase(dev) -> dict:
    """One generate of each model against the f32 forward (see
    ``LOGITS_TOL``), each with a control that must miss it:
    starcoder2-3b with its window cut to 16 against the same forward
    without the window, the recurrent models decoding the same tokens
    with their state zeroed before each step, and granite-moe-1b-a400m
    against its f32 plain prefill and decode steps (``moe_logits``) with
    one expert a token."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ModelContainer
    out = {}
    for arch in SERVE_MODELS:
        cfg = get_config(arch)
        if cfg.is_moe:
            c = ModelContainer(cfg, seed=1, device=dev, **SERVE_CKW)
            prompt = np.random.default_rng(12).integers(
                0, cfg.vocab_size, (1, 12)).astype(np.int32)
            r = moe_logits(c, prompt, 8, dict(experts_per_token=1))
            out[arch] = logits_row(
                arch + " (f32 plain prefill and decode steps)", r["errs"],
                LOGITS_TOL, "the f32 plain path with one expert a token",
                r["control_errs"], max_abs_err=r["max_abs_err"],
                logit_scale=r["logit_scale"],
                plain_bf16_rel_l2=r["plain_bf16_rel_l2"])
            del c
            gc.collect()
            continue
        variants = {arch: cfg}
        if cfg.sliding_window:
            variants[f"{arch} window 16"] = dataclasses.replace(
                cfg, sliding_window=16)
        for name, cfgv in variants.items():
            c = ModelContainer(cfgv, seed=1, device=dev, **SERVE_CKW)
            prompt = np.random.default_rng(12).integers(
                0, cfg.vocab_size, (1, 12)).astype(np.int32)
            tokens, logits = c.generate_with_logits(prompt, 8)
            s = c.prefill_len
            seq = np.zeros((1, s + 7), np.int32)
            seq[0, :12] = prompt[0]
            seq[0, s:] = tokens[0, :7]
            seq = torch.from_numpy(seq).to(dev)
            with torch.no_grad():
                want = plain_forward(cfgv, c.params, seq)[0, s - 1:]
                plain16 = plain_forward(cfgv, c.params, seq,
                                        torch.bfloat16)[0, s - 1:]
            control = control_errs = None
            if cfgv.sliding_window and cfgv.sliding_window < s + 7:
                control = "the f32 forward without the window"
                nowin = plain_forward(dataclasses.replace(
                    cfgv, sliding_window=None), c.params, seq)[0, s - 1:]
                control_errs = rel_errors(logits[0], nowin)
            elif cfgv.arch_type in ("hybrid", "ssm"):
                control = "decoding with the state zeroed each step"
                # the prefill's position is the same in both; the decode
                # steps are where a state that is not carried shows
                reset = decode_with_state_reset(c, prompt, tokens)
                control_errs = rel_errors(reset[1:], want[1:])
            tol = RWKV_LOGITS_TOL if cfgv.arch_type == "ssm" \
                else LOGITS_TOL
            out[name] = logits_row(
                f"{name} (bf16 kernel path vs f32 plain forward)",
                rel_errors(logits[0], want), tol, control, control_errs,
                max_abs_err=float((logits[0] - want).abs().max()),
                logit_scale=float(want.abs().max()),
                plain_bf16_rel_l2=rel_errors(plain16, want))
            del c, logits, want, plain16
            gc.collect()
    return out


#: The families phase's containers, one at a time: qwen2-vl-7b (VLM) and
#: whisper-medium (audio) at full width and depth, and kimi-k2-1t-a32b
#: (MoE: 384 experts, top 8, a shared expert, head dim 112) at full width
#: cut from 61 layers to ``KIMI_LAYERS``: one layer's experts are 33.8 GB
#: in bf16 and the whole model ~2 TB.
FAMILY_MODELS = ("qwen2-vl-7b", "whisper-medium", "kimi-k2-1t-a32b")
KIMI_LAYERS = 1
#: whisper's decoder cache: its 448 learned target positions.
WHISPER_MAX_LEN = 448
#: Vision patches spliced into qwen2-vl's 32-token prefill.
VLM_PATCHES = 16
#: Tokens a family's ``generate`` makes: a prefill and 8 decode steps.
FAMILY_NEW = 9


def family_config(arch: str):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == "kimi-k2-1t-a32b":
        cfg = dataclasses.replace(cfg, n_layers=KIMI_LAYERS)
    return cfg


def family_launches(cfg, prefills: int, decodes: int) -> dict:
    """B3 and B2 launches of ``prefills`` prefills and ``decodes`` decode
    steps: B3 once an attention layer (MoE layers included) a prefill and
    B2 once a decode step; whisper's B3 a prefill once an encoder layer
    and twice a decoder layer (self and cross), and once a decoder layer
    a decode step (the cross-attention of its one query)."""
    n = cfg.layer_kinds().count("attn")
    if cfg.is_encoder_decoder:
        return dict(flash_attention=(cfg.n_encoder_layers + 2 * n) * prefills
                    + n * decodes, decode_attention=n * decodes)
    return dict(flash_attention=n * prefills, decode_attention=n * decodes)


def vlm_logits(c) -> dict:
    """qwen2-vl-7b: ``VLM_PATCHES`` stub vision patches spliced into a
    32-token prefill with the stub's 3-D M-RoPE positions and explicit
    ``seq_positions``, then 7 decode steps at the text positions that
    follow, both rows; against the f32 plain forward of the whole
    sequence.  The control is that forward with 1-D (t, t, t) positions,
    so M-RoPE no longer sees the patch grid."""
    from repro_torch.models.frontends import stub_vision_patches
    from repro_torch.models.rope import mrope_text_positions
    cfg, dev, b = c.cfg, c.device, c.max_batch
    s, n_new = c.prefill_len, 8
    gen = torch.Generator(device=dev).manual_seed(14)
    emb, pp, pos = stub_vision_patches(gen, cfg, b, VLM_PATCHES,
                                       s + n_new - 1)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=dev, dtype=torch.int32)
    seq_pos = torch.arange(s + n_new, dtype=torch.int32,
                           device=dev)[None].expand(b, -1)
    first = {"tokens": toks, "patch_embeds": emb, "patch_positions": pp,
             "positions": pos[:, :s], "seq_positions": seq_pos[:, :s]}

    def step(i, t):
        return {"tokens": t, "positions": pos[:, s + i:s + i + 1],
                "seq_positions": seq_pos[:, s + i:s + i + 1]}
    with torch.no_grad():
        fed, got = path_logits(cfg, c.params, first, step, n_new, c.max_len)
        seq = torch.cat([toks, fed], 1)
        want = plain_forward(cfg, c.params, seq, positions=pos,
                             patches=(emb, pp))[:, s - 1:]
        flat = plain_forward(cfg, c.params, seq, positions=(
            mrope_text_positions(b, s + n_new - 1, device=dev)),
            patches=(emb, pp))[:, s - 1:]
    got, want, flat = (t.flatten(0, 1) for t in (got, want, flat))
    return logits_row(
        f"qwen2-vl-7b ({VLM_PATCHES} patches; f32 plain forward)",
        rel_errors(got, want), LOGITS_TOL,
        "the f32 forward with 1-D (t, t, t) positions",
        rel_errors(got, flat), max_abs_err=float((got - want).abs().max()),
        logit_scale=float(want.abs().max()))


def causal_cross_attention(cfg, p, x, enc_k, enc_v):
    """whisper's cross-attention with the causal mask: query i sees
    encoder frames 0..i only (the whisper logits check's control)."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import dense
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(b, s, h, hd)
    o = ops.flash_attention(q, enc_k, enc_v, causal=True)
    return dense(p["wo"], o.reshape(b, s, h * hd))


def whisper_logits(c) -> dict:
    """whisper-medium: stub audio frames, a 32-token decoder prefill and 7
    decode steps, both rows, against the f32 plain ``decode_train`` of the
    whole sequence; the control makes its cross-attention causal."""
    from repro_torch.models import whisper as W
    from repro_torch.models.frontends import stub_audio_frames
    cfg, dev, b = c.cfg, c.device, c.max_batch
    s, n_new = c.prefill_len, 8
    gen = torch.Generator(device=dev).manual_seed(15)
    frames = stub_audio_frames(gen, cfg, b)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=dev, dtype=torch.int32)
    first = {"frame_embeds": frames, "tokens": toks}

    def step(i, t):
        return {"tokens": t, "positions": torch.full(
            (b, 1), s + i, dtype=torch.int32, device=dev)}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        fed, got = path_logits(cfg, c.params, first, step, n_new, c.max_len)
        seq = torch.cat([toks, fed], 1)
        p32 = cast_f32(c.params)
        with plain_kernels():
            want = W.decode_train(cfg32, p32, frames, seq)[:, s - 1:]
            saved, W.cross_attention = W.cross_attention, \
                causal_cross_attention
            try:
                causal = W.decode_train(cfg32, p32, frames, seq)[:, s - 1:]
            finally:
                W.cross_attention = saved
        del p32
    got, want, causal = (t.flatten(0, 1) for t in (got, want, causal))
    return logits_row(
        "whisper-medium (stub frames; f32 plain decode_train)",
        rel_errors(got, want), LOGITS_TOL,
        "the f32 forward with a causal cross-attention",
        rel_errors(got, causal),
        max_abs_err=float((got - want).abs().max()),
        logit_scale=float(want.abs().max()))


def families_phase(dev) -> dict:
    """The VLM, audio and MoE families, one ``ModelContainer`` at a time,
    each freed before the next: its cold start; a ``generate`` of a
    32-token prefill and 8 decode steps at batch 2 with B2's and B3's
    counts zeroed just before and read just after, which must equal
    ``family_launches``; every token in the vocabulary; its logits check
    with a control that must miss; the peak device memory."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.serving import ModelContainer
    kernels = dict(flash_attention=flash_attention_cuda,
                   decode_attention=decode_attention_cuda)
    out, total = {}, dict.fromkeys(kernels, 0)
    for arch in FAMILY_MODELS:
        cfg = family_config(arch)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ckw = dict(SERVE_CKW, max_len=WHISPER_MAX_LEN) \
            if cfg.is_encoder_decoder else SERVE_CKW
        c = ModelContainer(cfg, seed=2, device=dev, **ckw)
        prompt = np.random.default_rng(13).integers(
            0, cfg.vocab_size, (2, 12)).astype(np.int32)
        for k in kernels.values():          # the family's path starts here
            k.launches = 0
        t0 = time.perf_counter()
        tokens = c.generate(prompt, FAMILY_NEW)
        gen_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}  # ... ends
        want = family_launches(cfg, 1, FAMILY_NEW - 1)
        check(launches == want, f"{arch}: launches {launches} != {want}")
        check(tokens.shape == (2, FAMILY_NEW) and bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            f"{arch}: tokens {tokens}")
        for n in total:
            total[n] += launches[n]
        print(f"family {arch} ({cfg.n_layers} layers): cold start "
              f"{c.cold_start_s:.2f} s, size {c.size_mb:.1f} MB; generate "
              f"of a {c.prefill_len}-token prefill and {FAMILY_NEW - 1} "
              f"decode steps at batch 2 in {gen_s:.3f} s, launches "
              f"{launches} == layers x calls", flush=True)
        if cfg.arch_type == "vlm":
            logits = vlm_logits(c)
        elif cfg.is_encoder_decoder:
            logits = whisper_logits(c)
        else:
            # at the prefill's last position every routed choice of the
            # token is dropped (C = 1 slot an expert for 64 tokens x 8
            # choices over 384 experts), so a change of routing cannot
            # show there; the shared expert runs at every position
            r = moe_logits(c, prompt[:1], 8, dict(n_shared_experts=0),
                           torch.bfloat16)
            logits = logits_row(
                f"{arch} ({KIMI_LAYERS} layer; bf16 plain prefill and "
                "decode steps)", r["errs"], LOGITS_TOL,
                "the bf16 plain path without the shared expert",
                r["control_errs"], max_abs_err=r["max_abs_err"],
                logit_scale=r["logit_scale"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"family {arch}: peak device memory {peak_gb:.2f} GB",
              flush=True)
        out[arch] = dict(layers=cfg.n_layers, cold_start_s=c.cold_start_s,
                         generate_s=gen_s, launches=launches,
                         size_mb=c.size_mb, peak_gb=peak_gb, logits=logits)
        del c
    gc.collect()
    return dict(models=out, launches=total)


# ---------------------------------------------------------------------------
# training (A16): B3-B5 inside their autograd Functions, launch.train
# ---------------------------------------------------------------------------

#: Each kernel's Function against autograd of its plain version: per
#: input, max |grad - plain grad| over max |plain grad|.  f32: both run
#: in f32 and differ in the order of their sums.  bf16: both round the
#: grads to bf16 and the plain attention's autograd also rounds dP to
#: bf16; the kernels' own bf16 bound (``ATTN_TOL``).
GRAD_FN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: The Function checks, at the training runs' shapes: B3 at (a)'s 100m
#: model (f32, 12 heads over 4) and at (b)'s zamba2 shared block (bf16,
#: 32 heads of 64, 512 tokens), B4 at (b)'s Mamba layers, B5 at (c)'s
#: rwkv6 layers (256 tokens).
TRAIN_FLASH = {"train-100m": ((8, 128, 128, 12, 4, 64, True, None, 0),
                              torch.float32),
               "train-zamba2": ((2, 512, 512, 32, 32, 64, True, None, 0),
                                torch.bfloat16)}
TRAIN_SSM = ("train-zamba2", (2, 512, 64, 64, 64, False))
TRAIN_WKV = ("train-rwkv6", (2, 256, 64, False))
#: (a) ``launch.train.main`` at ``--arch 100m``; (b) zamba2-1.2b at its
#: full config; (c) rwkv6-7b at full width cut to ``RWKV_TRAIN_LAYERS``
#: of its 32 layers (AdamW's state for all 7.6B params is ~91 GB).
TRAIN_100M = dict(steps=40, batch=8, seq=128)
TRAIN_ZAMBA = dict(steps=3, batch=2, seq=512)
TRAIN_RWKV = dict(steps=3, batch=2, seq=256)
RWKV_TRAIN_LAYERS = 4
#: The whole-model gradient check: zamba2-1.2b at full width cut to 6
#: layers (5 Mamba layers, the shared attention block at the sixth), a
#: 128-token batch of 2.
GRAD_LAYERS = 6
GRAD_SEQ = 128
#: Bounds on that check, against the plain path in f32 (every weight
#: cast to f32, every kernel replaced by its plain version): the loss's
#: relative error and each leaf's relative L2 error.  The bf16 path
#: drifts from f32 with or without the kernels, so the bounds sit above
#: the bf16 *plain* path's drift, as ``RWKV_LOGITS_TOL`` does: measured
#: (NVIDIA H100 80GB HBM3, 700.00 W), the bf16 plain path's loss is off
#: by 1.35e-4 and its worst leaf (``layers/4/ssm/dt_bias``) by 5.56%;
#: the kernel path's by 5.52e-5 and 5.56%.  A leaf the kernels cut off
#: (C4) has no gradient at all, and the check fails on that first.
GRAD_LOSS_TOL = 1e-3
GRAD_TOL = 0.10


def grad_rel(got, want) -> float:
    """max |got - want| over max |want|."""
    w = want.float()
    return float((got.float() - w).abs().max()
                 / w.abs().max().clamp(min=1e-30))


def rel_l2(got, want) -> float:
    w = want.float()
    return float((got.float() - w).norm() / w.norm().clamp(min=1e-30))


def function_check(what, dtype, fn, plain, bwd, inputs, fwd_tol, seed):
    """``fn`` (a kernel's Function) against ``plain`` on ``inputs``: the
    outputs within the forward's tolerance, then the grads of every input
    for one random upstream grad of every output against autograd of
    the plain version (``GRAD_FN_TOL``).  Times the explicit backward
    ``bwd`` (device, and back to back with its host cost) beside the
    forward kernel."""
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    outs, want = fn(*ins), plain(*ins)
    outs, want = (o if isinstance(o, tuple) else (o,) for o in (outs, want))
    fwd_err = max(close_check(o.detach(), w.detach(), dtype,
                              f"{what} forward {i}", fwd_tol)
                  for i, (o, w) in enumerate(zip(outs, want)))
    gen = torch.Generator(device=outs[0].device).manual_seed(seed)
    ups = [torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
           for o in outs]
    got = torch.autograd.grad(outs, ins, ups)
    ref = torch.autograd.grad(want, ins, ups)
    rels = [grad_rel(g, r) for g, r in zip(got, ref)]
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{what}: non-finite grad")
    check(max(rels) <= GRAD_FN_TOL[dtype], f"{what}: grads off autograd "
          f"of the plain version by {rels} > {GRAD_FN_TOL[dtype]}")
    del outs, want, got, ref
    plain_ins = [t.detach() for t in ins]
    bwd_ms = device_ms(lambda: bwd(*plain_ins, *ups), 3)
    bwd_call = call_ms(lambda: bwd(*plain_ins, *ups), 3)
    return dict(dtype=str(dtype), forward_max_abs_err=fwd_err,
                grad_rel_err=rels, tolerance=GRAD_FN_TOL[dtype],
                bwd_ms=bwd_ms, bwd_call_ms=bwd_call)


def function_phase(dev) -> dict:
    """B3, B4 and B5 inside their autograd Functions at the training
    runs' shapes, against autograd of the plain versions; each backward's
    time beside its forward kernel's, and SDPA's forward + backward at
    B3's shapes as the yardstick for a later hand-written backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_cuda, flash_attention_plain)
    from repro_torch.kernels.ssm_scan import (ssm_scan_bwd, ssm_scan_cuda,
                                              ssm_scan_plain)
    from repro_torch.kernels.wkv6 import wkv6_bwd, wkv6_cuda, wkv6_plain
    rows = {}
    for name, (shape, dtype) in TRAIN_FLASH.items():
        b, sq, skv, h, kv, d = shape[:6]
        q, k, v = flash_case(shape, dtype, dev, sq + 1)
        row = function_check(
            f"flash_attention {name}", dtype,
            lambda q, k, v: ops.FlashAttention.apply(q, k, v, True, None,
                                                     None, 0),
            flash_attention_plain,
            lambda q, k, v, do: flash_attention_bwd(q, k, v, do),
            (q, k, v), None, 1)
        row["fwd_ms"] = device_ms(lambda: flash_attention_cuda(q, k, v), 20)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        do = torch.randn(qt.shape, device=dev).to(dtype)

        def sdpa():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
            torch.autograd.grad(o, (qt, kt, vt), do)
        row["sdpa_fwd_bwd_ms"] = device_ms(sdpa, 10)
        rows[f"flash_attention {name}"] = dict(row, dims=list(shape[:6]))
    name, shape = TRAIN_SSM
    args, _ = ssm_case(shape, torch.bfloat16, dev, 3)
    row = function_check(
        f"ssm_scan {name}", torch.bfloat16,
        lambda *t: ops.SSMScan.apply(*t, None),
        lambda *t: ssm_scan_plain(*t),
        lambda x, dt, a, b, c, dy, dh: ssm_scan_bwd(x, dt, a, b, c, None,
                                                   dy, dh),
        args, SCAN_TOL[torch.bfloat16], 2)
    row["fwd_ms"] = device_ms(lambda: ssm_scan_cuda(*args), 20)
    rows[f"ssm_scan {name}"] = dict(row, dims=list(shape))
    name, shape = TRAIN_WKV
    args, _ = wkv_case(shape, torch.bfloat16, dev, 4)
    row = function_check(
        f"wkv6 {name}", torch.bfloat16,
        lambda *t: ops.WKV6.apply(*t, None), lambda *t: wkv6_plain(*t),
        lambda r, k, v, w, u, dy, ds: wkv6_bwd(r, k, v, w, u, None, dy, ds),
        args, SCAN_TOL[torch.bfloat16], 3)
    row["fwd_ms"] = device_ms(lambda: wkv6_cuda(*args), 20)
    rows[f"wkv6 {name}"] = dict(row, dims=list(shape))
    for name, row in rows.items():
        sdpa = row.get("sdpa_fwd_bwd_ms")
        print(f"function {name} {row['dims']} {row['dtype']}: forward == "
              f"plain (max abs err {row['forward_max_abs_err']:.2e}), grads "
              f"== autograd of the plain version (max rel err "
              f"{max(row['grad_rel_err']):.2e} <= {row['tolerance']}); "
              f"backward {row['bwd_ms']:.3f} ms device "
              f"({row['bwd_call_ms']:.3f} ms a call back to back) against "
              f"the forward kernel's {row['fwd_ms'] * 1e3:.2f} us"
              + (f"; sdpa forward + backward {sdpa:.3f} ms" if sdpa else ""),
              flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def model_grads(cfg, params, batch, remat):
    """(loss, {key: grad or None}) of ``loss_fn`` over every leaf."""
    from repro_torch._tree import tree_leaves, tree_unflatten
    from repro_torch.checkpoint.convert import flatten
    from repro_torch.models import loss_fn
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    total, _ = loss_fn(cfg, tree_unflatten(params, live), batch,
                       remat=remat)
    grads = torch.autograd.grad(total, live, allow_unused=True)
    return total.detach(), dict(zip(flatten(params), grads))


def model_grad_phase(dev) -> dict:
    """zamba2-1.2b at full width and ``GRAD_LAYERS`` layers (bf16): every
    leaf gets a finite gradient through B3's and B4's Functions (C4), the
    loss and each leaf's gradient within ``GRAD_LOSS_TOL`` / ``GRAD_TOL``
    of the f32 plain path (the bf16 plain path beside it, which sets the
    bounds), ``remat`` on equal to off, and a control: the kernels called
    without their Functions (the fault C4 repaired) leave leaves with no
    gradient."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("zamba2-1.2b"),
                              n_layers=GRAD_LAYERS)
    params = init_params(cfg, 5, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, GRAD_SEQ + 1),
                         generator=gen, device=dev, dtype=torch.int32)
    pos = torch.arange(GRAD_SEQ, dtype=torch.int32,
                       device=dev)[None].expand(2, GRAD_SEQ)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(), "positions": pos}
    loss, grads = model_grads(cfg, params, batch, remat=False)
    missing = sorted(k for k, g in grads.items() if g is None)
    check(not missing, f"C4: no gradient for {missing}")
    bad = sorted(k for k, g in grads.items()
                 if not bool(torch.isfinite(g).all()))
    check(not bad, f"non-finite gradient for {bad}")
    loss_r, grads_r = model_grads(cfg, params, batch, remat=True)
    remat_bitwise = bool(torch.equal(loss, loss_r)) and all(
        torch.equal(grads[k], grads_r[k]) for k in grads)
    remat_err = max(rel_l2(grads_r[k], grads[k]) for k in grads)
    check(torch.equal(loss, loss_r), f"remat changes the loss: "
          f"{float(loss)} != {float(loss_r)}")
    check(remat_err <= 1e-2, f"remat moves a gradient by {remat_err}")
    del grads_r
    saved = ops.needs_grad
    ops.needs_grad = lambda *t: False       # the kernels bare, as before
    try:
        _, grads_c = model_grads(cfg, params, batch, remat=False)
    finally:
        ops.needs_grad = saved
    control = sorted(k for k, g in grads_c.items() if g is None)
    check(bool(control), "control: the bare kernels left every leaf a "
          "gradient")
    del grads_c
    with plain_kernels():
        loss_pb, grads_pb = model_grads(cfg, params, batch, remat=False)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        loss_f, grads_f = model_grads(cfg32, cast_f32(params), batch,
                                      remat=False)
    errs = {k: rel_l2(g, grads_f[k]) for k, g in grads.items()}
    plain_errs = {k: rel_l2(g, grads_f[k]) for k, g in grads_pb.items()}
    kern_vs_plain = {k: rel_l2(g, grads_pb[k]) for k, g in grads.items()}
    loss_err = abs(float(loss) - float(loss_f)) / abs(float(loss_f))
    plain_loss_err = abs(float(loss_pb) - float(loss_f)) / abs(float(loss_f))
    worst = sorted(errs, key=errs.get, reverse=True)[:3]
    print(f"grads zamba2-1.2b ({GRAD_LAYERS} layers, full width, bf16, "
          f"seq {GRAD_SEQ}): all {len(grads)} leaves have a finite "
          f"gradient through the Functions; loss {float(loss):.5f} against "
          f"f32 plain {float(loss_f):.5f} (rel {loss_err:.2e}; bf16 plain "
          f"{plain_loss_err:.2e}; tolerance {GRAD_LOSS_TOL}); leaf rel L2 "
          f"against f32 plain: max {max(errs.values()):.4f} (bf16 plain "
          f"path: max {max(plain_errs.values()):.4f}; tolerance "
          f"{GRAD_TOL}), worst {[(k, round(errs[k], 4)) for k in worst]}; "
          f"against bf16 plain: max {max(kern_vs_plain.values()):.4f}; "
          f"remat on == off: loss bitwise, grads "
          f"{'bitwise' if remat_bitwise else f'within {remat_err:.2e}'}; "
          f"control (kernels without their Functions): {len(control)} of "
          f"{len(grads)} leaves get no gradient, e.g. {control[:3]}",
          flush=True)
    check(loss_err <= GRAD_LOSS_TOL, f"loss off f32 plain by {loss_err}")
    check(max(errs.values()) <= GRAD_TOL, f"a leaf's gradient is off f32 "
          f"plain by {max(errs.values())} > {GRAD_TOL}: {worst}")
    out = dict(layers=GRAD_LAYERS, seq=GRAD_SEQ, leaves=len(grads),
               loss=float(loss), loss_f32_plain=float(loss_f),
               loss_rel_err=loss_err, plain_bf16_loss_rel_err=plain_loss_err,
               max_leaf_rel_l2=max(errs.values()),
               plain_bf16_max_leaf_rel_l2=max(plain_errs.values()),
               max_leaf_rel_l2_vs_plain_bf16=max(kern_vs_plain.values()),
               worst=[(k, errs[k], plain_errs[k]) for k in worst],
               remat_bitwise=remat_bitwise, remat_max_rel_l2=remat_err,
               control_no_grad=len(control),
               tolerance=dict(loss=GRAD_LOSS_TOL, leaf=GRAD_TOL))
    del params, grads, grads_pb, grads_f
    gc.collect()
    torch.cuda.empty_cache()
    return out


class StepClock:
    """Stands in for ``launch.train.train_step``: each step's wall time to
    a synchronize, its loss, and one step (``profile_step``) under the
    profiler (CUDA records only) for the device's busy share (summed
    device time of every kernel and copy over that step's wall) and the
    kernels with the most device time."""

    def __init__(self, step_fn, profile_step):
        self.step_fn, self.profile_step = step_fn, profile_step
        self.walls, self.losses, self.busy = [], [], None

    def __call__(self, *args, **kw):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        i = len(self.walls)
        # the device's records only: recording every CPU op as well
        # doubles the step's wall on the host
        prof = profile(activities=[ProfilerActivity.CUDA]) \
            if i == self.profile_step else contextlib.nullcontext()
        with prof:
            t0 = time.perf_counter()
            out = self.step_fn(*args, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if i == self.profile_step:
            def dev_us(e):
                return getattr(e, "self_device_time_total", 0.0)
            events = prof.key_averages()
            dev_s = device_s(events)
            top = sorted(events, key=dev_us, reverse=True)[:5]
            self.busy = dict(share=dev_s / wall, wall_s=wall,
                             device_s=dev_s,
                             top=[(e.key[:60], dev_us(e) / 1e3)
                                  for e in top])
        self.walls.append(wall)
        self.losses.append(float(out[2]["loss"]))
        return out


def train_run(what, run, kernels, steps, tokens, profile_step) -> dict:
    """One training run through ``launch.train`` (``run()`` calls its
    ``main`` or ``run``), with every kernel count zeroed just before and
    read just after, the steps timed by ``StepClock``, the params handed
    to ``save_checkpoint`` kept, and the peak device memory."""
    from repro_torch.launch import train as T
    clock, saved = StepClock(T.train_step, profile_step), {}
    real_save = T.save_checkpoint

    def keep(directory, step, tree):
        saved["tree"] = tree
        return real_save(directory, step, tree)
    T.train_step, T.save_checkpoint = clock, keep
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        for k in kernels.values():          # the training path starts here
            k.launches = 0
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}  # ... ends
    finally:
        T.train_step, T.save_checkpoint = clock.step_fn, real_save
    check(len(clock.walls) == steps, f"{what}: {len(clock.walls)} steps")
    check(all(np.isfinite(clock.losses)), f"{what}: loss {clock.losses}")
    timed = [w for i, w in enumerate(clock.walls)
             if i and i != profile_step]
    step_s = float(np.mean(timed))
    out = dict(steps=steps, wall_s=wall, first_step_s=clock.walls[0],
               step_s=step_s, tokens_per_s=tokens / step_s,
               losses=clock.losses, busy=clock.busy, launches=launches,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"train {what}: {steps} steps, loss {clock.losses[0]:.4f} -> "
          f"{clock.losses[-1]:.4f}; step {step_s:.3f} s "
          f"({out['tokens_per_s']:.0f} tokens/s; the first "
          f"{clock.walls[0]:.2f} s); device busy "
          f"{100 * clock.busy['share']:.1f}% of a profiled step "
          f"({clock.busy['wall_s']:.3f} s; top device time: "
          + "; ".join(f"{k} {ms:.2f} ms" for k, ms in clock.busy["top"])
          + f"); peak {out['peak_gb']:.2f} GB; launches {launches}",
          flush=True)
    return out, saved.get("tree")


def training_phase(dev) -> dict:
    """Training (A16) on the card: the Functions' checks
    (``function_phase``), the whole-model gradient check
    (``model_grad_phase``), then three runs through ``launch.train``:
    (a) ``main`` at ``--arch 100m`` (f32, B3 on ``flash_fma_kernel``)
    with a checkpoint, whose loss must fall and whose checkpoint must
    restore bitwise into the params it was written from; (b) zamba2-1.2b
    at its full config (bf16, ``remat``: B3 on ``flash_wgmma_kernel``, B4
    on ``ssm_scan_mma_kernel``); (c) rwkv6-7b at full width and
    ``RWKV_TRAIN_LAYERS`` layers (bf16, ``remat``: B5).  Each run's
    launches must equal the layers of each kind x steps, twice with
    ``remat`` (the forward runs again in the backward pass); the
    backward passes launch no kernel."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda
    from repro_torch.launch import train as T
    kernels = dict(flash_attention=flash_attention_cuda,
                   ssm_scan=ssm_scan_cuda, wkv6=wkv6_cuda)
    functions = function_phase(dev)
    grads = model_grad_phase(dev)
    runs, total = {}, dict.fromkeys(kernels, 0)

    a = TRAIN_100M
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        runs["100m"], live = train_run(
            "repro-100m", lambda: T.main([
                "--arch", "100m", "--steps", str(a["steps"]), "--batch",
                str(a["batch"]), "--seq", str(a["seq"]), "--ckpt-dir",
                str(ckpt_dir)]), kernels, a["steps"], a["batch"] * a["seq"],
            a["steps"] // 2)
    print(log.getvalue(), end="", flush=True)
    last = next(line for line in reversed(log.getvalue().splitlines())
                if line.startswith("loss "))       # main's closing line
    losses = runs["100m"]["losses"]
    check(last.endswith("(improved)") and losses[-1] < losses[0],
          f"100m: the loss did not fall ({last})")
    cfg = T.train_100m_config()
    check(runs["100m"]["launches"] == dict(
        flash_attention=cfg.n_layers * a["steps"], ssm_scan=0, wkv6=0),
        f"100m launches {runs['100m']['launches']}")
    back = restore_checkpoint(str(ckpt_dir), a["steps"], live)
    from repro_torch.checkpoint.convert import flatten
    fl, fb = flatten(live), flatten(back)
    check(sorted(fl) == sorted(fb) and all(
        fb[k].dtype == v.dtype and torch.equal(fb[k], v)
        for k, v in fl.items()), "the checkpoint does not restore bitwise")
    runs["100m"]["checkpoint"] = f"{len(fl)} leaves restored bitwise"
    print(f"train repro-100m: checkpoint ckpt_{a['steps']:08d}.npz "
          f"restores {len(fl)} leaves bitwise into the live params",
          flush=True)
    del live, back, fl, fb
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    for key, cfg, spec in (
            ("zamba2-1.2b", get_config("zamba2-1.2b"), TRAIN_ZAMBA),
            ("rwkv6-7b", dataclasses.replace(get_config("rwkv6-7b"),
                                             n_layers=RWKV_TRAIN_LAYERS),
             TRAIN_RWKV)):
        runs[key], _ = train_run(
            f"{key} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.dtype}, "
            f"remat)",
            lambda: T.run(cfg, steps=spec["steps"],
                          global_batch=spec["batch"], seq_len=spec["seq"],
                          log_every=1, remat=True),
            kernels, spec["steps"], spec["batch"] * spec["seq"],
            spec["steps"] - 1)
        kinds = cfg.layer_kinds()
        want = dict(flash_attention=2 * spec["steps"] * kinds.count("attn"),
                    ssm_scan=2 * spec["steps"] * kinds.count("mamba"),
                    wkv6=2 * spec["steps"] * kinds.count("rwkv"))
        check(runs[key]["launches"] == want,
              f"{key}: launches {runs[key]['launches']} != {want}")
    for r in runs.values():
        for n in total:
            total[n] += r["launches"][n]
    gc.collect()
    torch.cuda.empty_cache()
    return dict(functions=functions, grads=grads, runs=runs,
                launches=total)


# ---------------------------------------------------------------------------
# sharding (A18a): the rules against the reference, a one-card DeviceMesh
# ---------------------------------------------------------------------------

#: The production meshes, as names and sizes (all the rules read), by
#: the names ``GOLDEN_SPECS`` files them under.
SPEC_MESHES = {"16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}
SPEC_MODES = ("train", "serve")
#: Every config's param specs at the production shapes, in both modes
#: on both meshes, as the JAX reference computes them (laid out per
#: layer as the port's params are): ``spec_digest`` of each.  Pinned by
#: ``tests/test_torch_sharding.py``.
GOLDEN_SPECS = {
    "granite-34b": {
        "train/16x16": "9ff36b33df550b26",
        "serve/16x16": "49e09293da94cf33",
        "train/2x16x16": "fab4fd08838f7dee",
        "serve/2x16x16": "49e09293da94cf33"},
    "kimi-k2-1t-a32b": {
        "train/16x16": "38554d7bae41e4f5",
        "serve/16x16": "5832e0b0ebd9a807",
        "train/2x16x16": "00889f267667a804",
        "serve/2x16x16": "5832e0b0ebd9a807"},
    "whisper-medium": {
        "train/16x16": "d0d0bf3acab841bb",
        "serve/16x16": "fde5f982fb8a62db",
        "train/2x16x16": "7450884bc34cfe8f",
        "serve/2x16x16": "fde5f982fb8a62db"},
    "qwen2-vl-7b": {
        "train/16x16": "37d8535f8e76d0ee",
        "serve/16x16": "711bc28203406267",
        "train/2x16x16": "3c483e00d2450552",
        "serve/2x16x16": "711bc28203406267"},
    "qwen2.5-32b": {
        "train/16x16": "f328b408b42dc281",
        "serve/16x16": "365a515973c49c61",
        "train/2x16x16": "9d38936a3bb70e2d",
        "serve/2x16x16": "365a515973c49c61"},
    "glm4-9b": {
        "train/16x16": "4a7c071c562dfed6",
        "serve/16x16": "8da63b98241818f7",
        "train/2x16x16": "ee72b9ae66c6f82a",
        "serve/2x16x16": "8da63b98241818f7"},
    "granite-moe-1b-a400m": {
        "train/16x16": "95d4bc252da613e4",
        "serve/16x16": "c7de7dc88498deb0",
        "train/2x16x16": "1261220db718e6ad",
        "serve/2x16x16": "c7de7dc88498deb0"},
    "starcoder2-3b": {
        "train/16x16": "e81a66a724c2af63",
        "serve/16x16": "daff9352cdc929d3",
        "train/2x16x16": "aa79283165753733",
        "serve/2x16x16": "daff9352cdc929d3"},
    "zamba2-1.2b": {
        "train/16x16": "ad7e10ddc8907858",
        "serve/16x16": "a102fd488c40befd",
        "train/2x16x16": "e6606248be387cae",
        "serve/2x16x16": "a102fd488c40befd"},
    "rwkv6-7b": {
        "train/16x16": "480cf70aa444f0a0",
        "serve/16x16": "4fad286ce98b0885",
        "train/2x16x16": "8003920cb36dd173",
        "serve/2x16x16": "4fad286ce98b0885"},
}
#: The model served through the one-card mesh: its full config (bf16,
#: 38 layers, d = 2,048), a prefill of ``SHARD_PROMPT`` tokens and
#: ``SHARD_DECODES`` decode steps at batch ``SHARD_BATCH``.
SHARD_ARCH = "zamba2-1.2b"
SHARD_BATCH = 2
SHARD_PROMPT = 32
SHARD_DECODES = 3
SHARD_CACHE_LEN = 64


class MeshShape:
    """A mesh's axis names and sizes, with no device behind them: what
    the sharding rules read, at any size."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def spec_digest(table: dict) -> str:
    """blake2s (8 bytes) of ``{key: spec entries}``, sorted by key, each
    spec's entries as JSON (a tuple of axes a list)."""
    rows = sorted((k, list(v)) for k, v in table.items())
    return hashlib.blake2s(json.dumps(rows).encode(),
                           digest_size=8).hexdigest()


def spec_tables(cfg) -> dict:
    """``{"<mode>/<mesh>": {key: spec entries}}``: the port's param
    specs of ``cfg`` at the production shapes."""
    from repro_torch._tree import flatten
    from repro_torch.launch.specs import params_shapes_for
    from repro_torch.models.sharding import param_specs
    shapes = params_shapes_for(cfg)
    return {f"{mode}/{name}": {
        k: tuple(v) for k, v in flatten(param_specs(
            cfg, shapes, MeshShape(mesh), mode)).items()}
        for name, mesh in SPEC_MESHES.items() for mode in SPEC_MODES}


def golden_misses(arch: str, tables: dict) -> list:
    """The ``"<mode>/<mesh>"`` tables whose digest is not the golden."""
    return sorted(k for k, t in tables.items()
                  if spec_digest(t) != GOLDEN_SPECS[arch].get(k))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def place(tree, specs, mesh) -> tuple:
    """Each leaf of ``tree`` put on ``mesh`` by ``distribute_tensor``
    under its spec's placements: (the tree of the local tensors, the
    keys whose local tensor is not the source's storage).  Each local
    tensor must be the source leaf, bitwise."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch._tree import flatten, map_with_keys
    from repro_torch.models.sharding import placements
    flat, copies = flatten(specs), []

    def one(key, leaf):
        want = placements(flat[key], mesh)
        dt = distribute_tensor(leaf, mesh, want)
        check(tuple(dt.placements) == want,
              f"{key}: placements {dt.placements} != {want}")
        local = dt.to_local()
        check(same_bits(local, leaf), f"{key}: to_local() is not the leaf")
        if local.untyped_storage().data_ptr() != \
                leaf.untyped_storage().data_ptr():
            copies.append(key)
        return local
    return map_with_keys(tree, one), copies


def sharding_phase(dev) -> dict:
    """The sharding rules and a one-card ``DeviceMesh`` (A18a):
    ``make_host_mesh()`` on this card (``nccl``, ``(1, 1)``); every
    config's param specs at the production shapes held to
    ``GOLDEN_SPECS`` (with a control: one leaf's spec altered must miss);
    then ``SHARD_ARCH`` at its full config, its params put on the mesh
    under its ``"serve"`` placements and its caches under ``cache_specs``
    (each local tensor bitwise the source), a prefill and
    ``SHARD_DECODES`` decode steps on the local tensors with
    ``partitioning`` off, on, on and off, which must agree bitwise
    (logits and caches), with B2-B4's counts zeroed just before each run
    and read just after, equal to the layers x calls; and the
    constraints on a ``DTensor`` on the mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch._tree import flatten
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import partitioning
    from repro_torch.models.sharding import (cache_specs, data_axes,
                                             param_specs)
    kernels = dict(flash_attention=flash_attention_cuda,
                   decode_attention=decode_attention_cuda,
                   ssm_scan=ssm_scan_cuda)
    t0 = time.perf_counter()
    mesh = make_host_mesh()
    check(dist.get_backend() == "nccl" and mesh.device_type == "cuda"
          and tuple(mesh.shape) == (1, 1)
          and mesh.mesh_dim_names == ("data", "model"),
          f"host mesh {mesh} on {dist.get_backend()}")
    print(f"sharding: make_host_mesh() {mesh} over "
          f"{dist.get_backend()} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    sharded = {}
    for arch in ARCH_IDS:
        tables = spec_tables(get_config(arch))
        miss = golden_misses(arch, tables)
        check(not miss, f"{arch}: specs {miss} differ from GOLDEN_SPECS")
        sharded[arch] = {k: sum(any(e is not None for e in s)
                                for s in t.values())
                         for k, t in tables.items()}
        print(f"sharding {arch}: {len(tables['train/16x16'])} leaves, "
              f"sharded {sharded[arch]} == GOLDEN_SPECS", flush=True)
    tables = spec_tables(get_config(SHARD_ARCH))
    table = tables["serve/16x16"]
    key = next(k for k, s in table.items() if "model" in s)
    table[key] = (None,) * len(table[key])
    check(golden_misses(SHARD_ARCH, tables) == ["serve/16x16"],
          "control: an altered spec passed the golden check")
    print(f"sharding: {len(ARCH_IDS)} configs x {len(SPEC_MODES)} modes x "
          f"{len(SPEC_MESHES)} meshes == GOLDEN_SPECS in "
          f"{time.perf_counter() - t0:.2f} s; control ({key} replicated) "
          "missed", flush=True)

    cfg = get_config(SHARD_ARCH)
    kinds = cfg.layer_kinds()
    gc.collect()
    params = init_params(cfg, seed=3, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    local, copies = place(params, param_specs(cfg, params, mesh, "serve"),
                          mesh)
    torch.cuda.synchronize()
    extra_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    n_leaves = len(flatten(params))
    print(f"sharding {SHARD_ARCH}: {n_leaves} params on the mesh, "
          f"to_local() bitwise; {n_leaves - len(copies)} share the "
          f"source's storage, {len(copies)} copied, extra peak "
          f"{extra_gb:.3f} GB", flush=True)

    prompt = torch.from_numpy(np.random.default_rng(17).integers(
        0, cfg.vocab_size, (SHARD_BATCH, SHARD_PROMPT)).astype(np.int32)
                              ).to(dev)

    def batch(tokens, pos0):
        b, s = tokens.shape
        pos = torch.arange(pos0, pos0 + s, dtype=torch.int32,
                           device=dev)[None].expand(b, s)
        return {"tokens": tokens, "positions": pos, "seq_positions": pos}

    def serve(on: bool) -> dict:
        if on:
            partitioning.enable(data_axes(mesh), "model")
        for k in kernels.values():      # the path starts here
            k.launches = 0
        t0 = time.perf_counter()
        logits, caches = prefill(cfg, local, batch(prompt, 0),
                                 cache_len=SHARD_CACHE_LEN)
        caches, cache_copies = place(
            caches, cache_specs(cfg, caches, mesh), mesh)
        steps = [logits[:, -1]]
        for i in range(SHARD_DECODES):
            nxt = steps[-1].argmax(-1).to(torch.int32)[:, None]
            logits, caches = decode_step(cfg, local,
                                         batch(nxt, SHARD_PROMPT + i), caches)
            steps.append(logits[:, -1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}  # ... ends
        on_now = partitioning.is_enabled()
        partitioning.disable()
        check(on_now == on, "partitioning did not stay as set")
        return dict(logits=torch.stack(steps, 1), caches=caches,
                    launches=launches, wall_s=wall,
                    cache_copies=len(cache_copies),
                    cache_leaves=len(flatten(caches)))

    # off, on, on, off: the first run also warms the path up
    runs = [dict(serve(on), on=on) for on in (False, True, True, False)]
    want = dict(flash_attention=kinds.count("attn"),
                decode_attention=kinds.count("attn") * SHARD_DECODES,
                ssm_scan=kinds.count("mamba"))
    first = runs[0]
    check(first["logits"].shape == (SHARD_BATCH, SHARD_DECODES + 1,
                                    cfg.vocab_size)
          and bool(torch.isfinite(first["logits"]).all()),
          f"logits {tuple(first['logits'].shape)} not finite")
    fa = flatten(first["caches"])
    for i, r in enumerate(runs):
        check(r["launches"] == want,
              f"run {i}: launches {r['launches']} != {want}")
        check(same_bits(r["logits"], first["logits"]),
              f"run {i}: logits differ from run 0")
        fb = flatten(r["caches"])
        check(fa.keys() == fb.keys() and all(same_bits(fa[k], fb[k])
                                             for k in fa),
              f"run {i}: caches differ from run 0")
    walls = {name: [r["wall_s"] for r in runs if r["on"] == on]
             for name, on in (("on", True), ("off", False))}
    print(f"sharding {SHARD_ARCH}: a {SHARD_PROMPT}-token prefill and "
          f"{SHARD_DECODES} decode steps at batch {SHARD_BATCH} on the "
          "local tensors, partitioning off, on, on, off: "
          + ", ".join(f"{r['wall_s']:.3f}" for r in runs) + " s; logits "
          f"and {len(fa)} cache leaves bitwise equal "
          f"({first['cache_copies']} of {first['cache_leaves']} cache "
          f"leaves copied by the placement); launches a run {want} == "
          "layers x calls", flush=True)

    # the constraints on a DTensor of the mesh: batch over data, vocab
    # over model
    partitioning.enable(data_axes(mesh), "model")
    logits = first["logits"]
    x = distribute_tensor(logits, mesh, (Replicate(), Replicate()))
    for fn, want_pl in ((partitioning.hidden, (Shard(0), Replicate())),
                        (partitioning.logits, (Shard(0), Shard(2)))):
        y = fn(x)
        check(tuple(y.placements) == want_pl
              and same_bits(y.to_local(), logits),
              f"{fn.__name__}: {y.placements} != {want_pl}")
    partitioning.disable()
    check(fn(x) is x, "a constraint moved a tensor while disabled")
    print("sharding: hidden() and logits() redistribute a DTensor of the "
          "mesh to (Shard(0), Replicate()) and (Shard(0), Shard(2)); "
          "disabled, they return it as it is", flush=True)
    del params, local, runs, first, logits, x, y
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(sharded_leaves=sharded, param_copies=len(copies),
                param_leaves=n_leaves, extra_peak_gb=extra_gb,
                wall_s=walls, launches={n: v * 4 for n, v in want.items()})


def build_phase(_build) -> None:
    """Build every kernel, one ``nvcc`` each, all started together."""
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     ssm_scan, wkv6)
    jobs = [("pool_step", _build.NVCC_FLAGS), flash_attention.BUILD,
            decode_attention.BUILD, ssm_scan.BUILD, wkv6.BUILD]
    _build.build.cache_clear()
    t0 = time.perf_counter()
    built = _build.build_parallel(jobs)
    print(f"build: {len(jobs)} kernels in {time.perf_counter() - t0:.2f} s "
          "(one nvcc each, in parallel)")
    for (name, _), (lib, log, build_s) in zip(jobs, built):
        print(f"build {name}: {lib.name}, nvcc {build_s:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def kernel_entry(name, source, replaces, rows, main_shape, by_path,
                 cuda_kernels):
    """The ``kernels`` line's entry for B2-B5 (``rows`` from the attention
    or scan phase; numbers at ``main_shape``, in bf16; ``by_path`` the
    launches of each path that runs the kernel)."""
    main_row = next(r for r in rows if r["shape"] == main_shape)
    launches = sum(by_path.values())
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, launches_by_path=by_path,
                cuda_kernels=cuda_kernels,
                cuda_kernel_launches=len(cuda_kernels) * launches,
                max_abs_err=max(max(r["max_abs_err"].values())
                                for r in rows),
                ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                bound_ms=main_row["bound_ms"],
                bound_by=main_row["bound_by"],
                library_ms=main_row["library_ms"], shape=main_shape,
                dtype="bfloat16", per_shape=rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    # f32 products in full f32: the references below are f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, numpy "
          f"{np.__version__}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    t_start = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        return out
    phase("build", build_phase, _build)
    from repro_torch.cluster.graphs import BLOCK_EVENTS
    from repro_torch.workloads import quickstart_trace
    trace = quickstart_trace()
    kernels = phase("kernel", kernel_phase, dev)
    attention = phase("attention", attention_phase, dev)
    scans = phase("scan", scan_phase, dev)
    path = phase("path", path_phase, dev, trace)
    failures = phase("failures", failure_phase, dev, trace)
    autoscale = phase("autoscale", autoscale_phase, dev, trace)
    telemetry = phase("telemetry", telemetry_phase, dev, trace)
    vertical = phase("vertical", vertical_phase, dev, trace)
    sweeps = phase("sweep", sweep_phase, dev, trace, path["runs"])
    oracle = phase("oracle", oracle_phase, dev, trace, {
        **sweeps["oracle_runs"], **failures["oracle_runs"],
        **autoscale["oracle_runs"]})
    busy = phase("busy", busy_phase, dev, trace)
    serving = phase("serving", serving_phase, dev)
    eviction = phase("eviction", eviction_phase, dev, serving["sizes"])
    logits = phase("logits", logits_phase, dev)
    families = phase("families", families_phase, dev)
    training = phase("training", training_phase, dev)
    sharding = phase("sharding", sharding_phase, dev)
    total_s = time.perf_counter() - t_start
    print("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                 seconds.items())
          + f"; total {total_s:.1f} s", flush=True)

    main_row = kernels["rows"][0]            # [2, 1024]: Scenario.kiss
    b1_path = (path["launches"] + autoscale["launches"]
               + telemetry["launches"] + vertical["launches"]
               + sweeps["launches"] + sweeps["sharded"]["launches"]
               + oracle["launches"])
    entries = [dict(name="pool_step.evict_place", route="cuda",
                    source="src/repro_torch/kernels/csrc/pool_step.cu",
                    replaces="src/repro/kernels/pool_step.py:43",
                    launches=b1_path,
                    launches_by_path=dict(
                        simulator=path["launches"],
                        autoscale=autoscale["launches"],
                        telemetry_chains=telemetry["launches"],
                        vertical=vertical["launches"],
                        sweep=sweeps["launches"],
                        sweep_sharded=sweeps["sharded"]["launches"],
                        oracle=oracle["launches"],
                        failures=failures["launches"]),
                    cuda_kernels=POOL_KERNELS,
                    cuda_kernel_launches=b1_path,
                    max_abs_err=max(r["max_abs_err"]
                                    for r in kernels["rows"]),
                    ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                    bound_ms=main_row["bound_ms"],
                    bound_by=main_row["bound_by"], library_ms=None,
                    shape=main_row["shape"], per_shape=kernels["rows"]),
               kernel_entry(
                   "flash_attention",
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:26",
                   attention["flash"], "path-starcoder2",
                   dict(serving=serving["launches"]["flash_attention"],
                        families=families["launches"]["flash_attention"],
                        training=training["launches"]["flash_attention"],
                        sharding=sharding["launches"]["flash_attention"]),
                   FLASH_KERNELS[torch.bfloat16]),
               kernel_entry(
                   "decode_attention",
                   "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:30",
                   attention["decode"], "path-starcoder2",
                   dict(serving=serving["launches"]["decode_attention"],
                        families=families["launches"]["decode_attention"],
                        sharding=sharding["launches"]["decode_attention"]),
                   DECODE_KERNELS[torch.bfloat16]),
               kernel_entry(
                   "ssm_scan", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                   "src/repro/kernels/ssm_scan.py:29", scans["ssm_scan"],
                   "path-zamba2",
                   dict(serving=serving["launches"]["ssm_scan"],
                        training=training["launches"]["ssm_scan"],
                        sharding=sharding["launches"]["ssm_scan"]),
                   SCAN_KERNELS["ssm_scan"][torch.bfloat16]),
               # most of B5's launches are decode steps (S = 1)
               kernel_entry(
                   "wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
                   "src/repro/kernels/wkv6.py:24", scans["wkv6"],
                   "path-rwkv6-decode",
                   dict(serving=serving["launches"]["wkv6"],
                        training=training["launches"]["wkv6"]),
                   SCAN_KERNELS["wkv6"][torch.bfloat16])]
    print("kernels: " + json.dumps([e["name"] for e in entries]))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "simulator": {"block_events": BLOCK_EVENTS, "runs": path["runs"],
                      "counts": path["counts"]},
        "failures": {"runs": failures["runs"],
                     "counts": failures["counts"]},
        "autoscale": {"runs": autoscale["runs"],
                      "counts": autoscale["counts"]},
        "telemetry_chains": {"runs": telemetry["runs"],
                             "counts": telemetry["counts"]},
        "vertical": {"runs": vertical["runs"], "counts": vertical["counts"],
                     "overhead": vertical["overhead"]},
        "sweep": {k: sweeps[k] for k in ("runs", "counts",
                                         "batching_factor",
                                         "single_events_per_s")},
        "sweep_sharded": sweeps["sharded"],
        "oracle": {k: oracle[k] for k in (
            "runs", "counts", "ingest_s", "host_events", "host_s",
            "host_events_per_s", "analyze")},
        "device_busy_share": busy,
        "serving": {k: serving[k] for k in ("stats", "wall_s", "models",
                                            "peak_gb", "busy")},
        "eviction": eviction["rows"], "logits": logits,
        "families": families["models"],
        "training": {k: training[k] for k in ("functions", "grads",
                                              "runs")},
        "sharding": sharding,
        "phase_seconds": seconds, "seconds": total_s, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
