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
   simulator's shapes and a ragged one, bitwise on every output, then
   timed per launch with CUDA events, and alone by the profiler, which
   must see its one kernel, ``evict_place_kernel``;
4. kernels B3 (flash attention) and B2 (decode attention) against their
   plain versions at the serving path's shapes (starcoder2-3b, glm4-9b
   and zamba2-1.2b's shared MHA block), kimi-k2's (head dim 112, a
   group of 8), long shapes and ragged ones, in
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
   ``tests/test_torch_replay.py``), bitwise; a CPU ``gather`` run must
   match them too; each run prints its events/s and the share of its
   wall spent capturing;
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
   stored trace in every mode, held to ``GOLDEN_TEL`` and
   ``GOLDEN_CHAIN`` (every window array, every per-chain array, the
   summary; pinned by ``tests/test_torch_{telemetry,chains}.py``); then
   the device's busy share and device records an event over two graph
   replays, for the static and the autoscaled runner and for telemetry
   and chains on, with B1's kernel records in ``fused`` seen at most
   once an event;
7. the serving path at full width: the four models of
   ``launch.serve.default_registry(4)``, starcoder2-3b, rwkv6-7b,
   zamba2-1.2b and glm4-9b (random bf16 weights from a seed), behind one
   ``KissServer`` on the card, 16 requests through ``launch.serve.run``,
   with B2-B5's launch counts zeroed just before and read just after;
   they must equal the layers of each kind times the prefills and decode
   steps the requests ask for;
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
   miss;
10. one JSON line of kernel measurements, one of path numbers, then
   ``{"ok": true, ...}``.

Any mismatch or fault exits non-zero; no phase's failure is caught.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
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

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core op/s,
#: dense bf16 tensor-core op/s.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
BF16_OPS_S = 989e12

KERNEL_SHAPES = ((2, 1024), (32, 256), (3, 1000))   # path, path, ragged
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
    summaries, runs = {}, {}
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
                summaries[name, mode] = check_result(name, mode, res, n)
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
        res = simulate(scn, head, mode="gather", device="cpu")
        dt = time.perf_counter() - t0
        summary = check_result(name, "cpu", res, n)
        for mode in modes:
            check(summaries[name, mode] == summary,
                  f"{name}/{mode}: summary differs from the CPU run")
        runs[f"{name}/gather/cpu"] = dict(events=n, wall_s=dt,
                                          events_per_s=n / dt)
        print(f"path {name} mode=gather on cpu: {n / dt:.1f} events/s; "
              f"equal to the card's runs", flush=True)
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
        counts = total.delta()                # ... and ends here
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"failures: every run matches the JAX reference bitwise "
          f"(invalidated {GOLDEN_FAIL['invalidated'][:3]}..., downtime "
          f"{GOLDEN_FAIL['downtime_pct']}%); B1 launched "
          f"{counts['b1_launches']} times", flush=True)
    return {"launches": counts["b1_launches"], "counts": counts,
            "runs": runs}


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
            "runs": runs}


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
    capture); ``chain_scenarios`` over the chain benchmark's trace in
    every mode, ``slack_aware`` in ``fused`` also in chunks of
    ``CHAIN_CHUNK``; and het16 autoscaled with telemetry in ``fused``.
    Every run goes through the block runner (its counts and B1's are
    checked) and is held to ``GOLDEN_TEL``/``GOLDEN_CHAIN``."""
    from repro_torch.sim import simulate
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
        for name, scn in chains.items():
            for mode in ("gather", "vmap", "fused"):
                held(name, f"chains/{name}/{mode}",
                     f"chains {name} mode={mode}", [nc], mode, scn, ctr,
                     GOLDEN_CHAIN)
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


def busy_phase(dev, trace) -> dict:
    """Device busy share and device records an event over two graph
    replays (the first ``2 * BLOCK_EVENTS`` events) of the kiss scenario,
    for the static runner and the autoscaled one (an epoch of
    ``ASC_EPOCH`` events, so the window holds no re-split: the per-event
    cost of the live mask and the pressure), and of the ``slack_aware``
    chain scenario on the chain benchmark's trace (telemetry and chains
    on, the runner with failures), each in ``gather`` and ``fused``:
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
    from repro_torch.sim import Autoscale, simulate
    from repro_torch.workloads import benchmark_chained_trace
    n_events = 2 * BLOCK_EVENTS
    head, kiss = trace.head(n_events), scenarios()["kiss4096"]
    flavours = {"static": (kiss, head), "autoscaled": (dataclasses.replace(
        kiss, autoscale=Autoscale(epoch_events=ASC_EPOCH)), head),
        "telemetry+chains": (chain_scenarios()["slack_aware"],
                             benchmark_chained_trace().head(n_events))}
    out = {}

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0)
    for flavour, (scn, head) in flavours.items():
        for mode in ("gather", "fused"):
            simulate(scn, head.head(50), mode=mode, device=dev)  # warm-up
            for attempt in range(4):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    simulate(scn, head, mode=mode, device=dev)
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
            busy = sum(dev_us(e) for e in events) / 1e6 / wall
            out[f"{flavour}/{mode}"] = dict(
                busy=busy, device_records_per_event=records / n_events,
                b1_records=b1)
            print(f"{what}: device busy {100 * busy:.1f}% of {wall:.2f} s "
                  f"wall over {n_events} events; {records / n_events:.2f} "
                  f"device records an event; {b1} evict_place_kernel "
                  "records; top device time: "
                  + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.1f} ms"
                              for e in top), flush=True)
    return out


#: ``launch.serve.default_registry(4)``'s models, at full width.
SERVE_MODELS = ("starcoder2-3b", "rwkv6-7b", "zamba2-1.2b", "glm4-9b")
SERVE_REQUESTS = 16
#: The models of the eviction phase.
EVICT_MODELS = ("starcoder2-3b", "glm4-9b")
SERVE_CKW = dict(max_batch=2, max_len=4096)
#: The KissServer's budget: the threshold puts starcoder2-3b and
#: zamba2-1.2b in the small class and rwkv6-7b and glm4-9b in the large
#: one, and by the f32 estimates each pool holds both of its models
#: (12,722 + 6,186 = 18,909 MB of 24,000; 30,066 + 37,599 = 67,665 MB of
#: 72,000; pinned by tests/test_torch_serving.py).
SERVE_BUDGET = dict(total_mb=96_000, small_frac=0.25, threshold_mb=20_000)
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
    """Full-width starcoder2-3b, rwkv6-7b, zamba2-1.2b and glm4-9b behind
    one KissServer: ``SERVE_REQUESTS`` requests through
    ``launch.serve.run``, with B2-B5's counts zeroed just before and read
    just after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda
    from repro_torch.launch.serve import (default_registry, run,
                                          synthesize_requests)
    from repro_torch.serving import KissServer
    check(tuple(default_registry(4)) == SERVE_MODELS,
          f"default_registry(4) is {list(default_registry(4))}")
    registry = {a: get_config(a) for a in SERVE_MODELS}
    server = KissServer(registry, **SERVE_BUDGET,
                        container_kwargs=dict(SERVE_CKW, device=dev))
    check([server.size_class(m) for m in SERVE_MODELS] == [0, 1, 0, 1],
          "starcoder2-3b and zamba2-1.2b must be small, rwkv6-7b and "
          "glm4-9b large")
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
    share = sum(dev_us(e) for e in events) / 1e6 / wall
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
    from repro_torch.kernels import flash_attention, ops, ssm_scan, wkv6
    saved = (ops.flash_attention, ops.ssm_scan, ops.wkv6)
    ops.flash_attention = flash_attention.flash_attention_plain
    ops.ssm_scan = ssm_scan.ssm_scan_plain
    ops.wkv6 = wkv6.wkv6_plain
    try:
        yield
    finally:
        ops.flash_attention, ops.ssm_scan, ops.wkv6 = saved


def plain_forward(cfg, params, tokens, dtype=torch.float32):
    """Logits f32 [B, S, V] of the whole sequence with no cache: the
    port's own blocks with every kernel replaced by its plain version, in
    f32 (every weight cast to f32 a layer at a time, the hybrid's shared
    block once) or, with ``dtype=torch.bfloat16``, with the weights as
    they are."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed

    def cast(tree):
        if dtype != torch.float32:
            return tree
        return {k: cast(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32,
                       device=tokens.device)[None].expand(b, s)
    x = embed(params["embed"], tokens.long(), dtype)
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
                x, _ = T._attn_block(cfg, lp, x, pos, mode="train")
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


def logits_phase(dev) -> dict:
    """One generate of each model against the f32 forward (see
    ``LOGITS_TOL``), each with a control that must miss it:
    starcoder2-3b with its window cut to 16 against the same forward
    without the window, and the recurrent models decoding the same tokens
    with their state zeroed before each step."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ModelContainer
    out = {}
    for arch in SERVE_MODELS:
        cfg = get_config(arch)
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
            errs = rel_errors(logits[0], want)
            row = dict(rel_l2=errs, max_abs_err=float(
                (logits[0] - want).abs().max()),
                logit_scale=float(want.abs().max()),
                plain_bf16_rel_l2=rel_errors(plain16, want))
            control = None
            if cfgv.sliding_window and cfgv.sliding_window < s + 7:
                control = "the f32 forward without the window"
                nowin = plain_forward(dataclasses.replace(
                    cfgv, sliding_window=None), c.params, seq)[0, s - 1:]
                row["control_rel_l2"] = rel_errors(logits[0], nowin)
            elif cfgv.arch_type in ("hybrid", "ssm"):
                control = "decoding with the state zeroed each step"
                # the prefill's position is the same in both; the decode
                # steps are where a state that is not carried shows
                reset = decode_with_state_reset(c, prompt, tokens)
                row["control_rel_l2"] = rel_errors(reset[1:], want[1:])
            tol = RWKV_LOGITS_TOL if cfgv.arch_type == "ssm" \
                else LOGITS_TOL
            out[name] = dict(row, tolerance=tol, control=control)
            print(f"logits {name}: bf16 kernel path vs f32 plain forward, "
                  f"relative L2 per position "
                  f"{[round(e, 5) for e in errs]} (tolerance {tol}),"
                  f" max abs err {row['max_abs_err']:.4f} of logits up to "
                  f"{row['logit_scale']:.2f}; the bf16 plain forward "
                  f"{[round(e, 5) for e in row['plain_bf16_rel_l2']]}" + (
                      f"; control ({control}) " + str(
                          [round(e, 4) for e in row["control_rel_l2"]])
                      if control else ""), flush=True)
            check(max(errs) <= tol,
                  f"{name}: logits off by {max(errs):.4f} > {tol}")
            if control:
                check(min(row["control_rel_l2"]) > tol,
                      f"{name}: the control ({control}) is within {tol} "
                      "of the f32 forward")
            del c, logits, want, plain16
            gc.collect()
    return out


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


def kernel_entry(name, source, replaces, rows, main_shape, launches,
                 cuda_kernels):
    """The ``kernels`` line's entry for B2-B5 (``rows`` from the attention
    or scan phase; numbers at ``main_shape``, in bf16)."""
    main_row = next(r for r in rows if r["shape"] == main_shape)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, cuda_kernels=cuda_kernels,
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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t_start = time.perf_counter()
    build_phase(_build)
    from repro_torch.cluster.graphs import BLOCK_EVENTS
    from repro_torch.workloads import quickstart_trace
    trace = quickstart_trace()
    kernels = kernel_phase(dev)
    attention = attention_phase(dev)
    scans = scan_phase(dev)
    path = path_phase(dev, trace)
    failures = failure_phase(dev, trace)
    autoscale = autoscale_phase(dev, trace)
    telemetry = telemetry_phase(dev, trace)
    busy = busy_phase(dev, trace)
    serving = serving_phase(dev)
    eviction = eviction_phase(dev, serving["sizes"])
    logits = logits_phase(dev)

    main_row = kernels["rows"][0]            # [2, 1024]: Scenario.kiss
    b1_path = (path["launches"] + autoscale["launches"]
               + telemetry["launches"])
    entries = [dict(name="pool_step.evict_place", route="cuda",
                    source="src/repro_torch/kernels/csrc/pool_step.cu",
                    replaces="src/repro/kernels/pool_step.py:43",
                    launches=b1_path,
                    launches_by_path=dict(
                        simulator=path["launches"],
                        autoscale=autoscale["launches"],
                        telemetry_chains=telemetry["launches"],
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
                   serving["launches"]["flash_attention"],
                   FLASH_KERNELS[torch.bfloat16]),
               kernel_entry(
                   "decode_attention",
                   "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:30",
                   attention["decode"], "path-starcoder2",
                   serving["launches"]["decode_attention"],
                   DECODE_KERNELS[torch.bfloat16]),
               kernel_entry(
                   "ssm_scan", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                   "src/repro/kernels/ssm_scan.py:29", scans["ssm_scan"],
                   "path-zamba2", serving["launches"]["ssm_scan"],
                   SCAN_KERNELS["ssm_scan"][torch.bfloat16]),
               # most of B5's launches are decode steps (S = 1)
               kernel_entry(
                   "wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
                   "src/repro/kernels/wkv6.py:24", scans["wkv6"],
                   "path-rwkv6-decode", serving["launches"]["wkv6"],
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
        "device_busy_share": busy,
        "serving": {k: serving[k] for k in ("stats", "wall_s", "models",
                                            "peak_gb", "busy")},
        "eviction": eviction["rows"], "logits": logits,
        "seconds": time.perf_counter() - t_start, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
