"""Decode attention in hand-written CUDA (split-KV), and its plain version.

Port of ``repro.kernels.decode_attention`` (the Pallas kernel ``_kernel``)
and of its oracle ``repro.kernels.ref.decode_attention``: one query token
per sequence, q ``[B, H, D]``, against a (ring) KV cache k/v
``[B, S, KV, D]`` whose ``slot_pos`` i32 ``[B, S]`` holds the absolute
position in each slot (-1 when empty).  A slot is visible when
``0 <= slot_pos <= cur`` and, with a window, ``slot_pos > cur - window``.

* :func:`decode_attention_cuda` launches ``csrc/decode_attention.cu`` (a
  split kernel over chunks of the cache, then a combine kernel) on a CUDA
  tensor and raises on anything else: in bf16 the split kernel is
  ``decode_mma_kernel`` (``mma.sync`` on the tensor cores, the GQA
  group's query heads as the M rows), in f32 ``decode_fma_kernel`` (f32
  FMAs on the CUDA cores, which the f32 tolerance of 2e-5 needs);
* :func:`decode_attention_plain` is the oracle in plain torch.

``repro_torch.kernels.ops.decode_attention`` takes the kernel for CUDA
tensors and the plain version for CPU tensors, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
#: Head dims the kernel is built for: 64, kimi-k2's 112, and 128.
HEAD_DIMS = (64, 112, 128)
#: Cache slots one block of the split kernel reads (``CHUNK`` in the .cu).
CHUNK = 128
#: Query heads a kv head may serve (the split kernel's shared memory).
MAX_GROUP = 64
#: Cache slots: the combine kernel keeps 8 bytes a chunk in the 48 KB of
#: shared memory a block gets without an opt-in.
MAX_SLOTS = 6144 * CHUNK
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BUILD = ("decode_attention", _build.ATTENTION_FLAGS)


def _cur(cur_pos, b: int, device) -> torch.Tensor:
    """``cur_pos`` (an int, a 0-d or a ``[B]`` tensor) as i32 ``[B]``."""
    if isinstance(cur_pos, torch.Tensor):
        return cur_pos.to(device=device, dtype=torch.int32).expand(b) \
            .contiguous()
    return torch.full((b,), int(cur_pos), dtype=torch.int32, device=device)


def decode_attention_plain(q, k_cache, v_cache, slot_pos, cur_pos, *,
                           window=None, scale=None):
    """The reference oracle in torch: scores in f32 (q pre-scaled in its
    own dtype), invisible slots at ``NEG_INF``, softmax in f32, weights
    cast to v's dtype for the value product, result in q's dtype."""
    b, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    qr = (q * scale).reshape(b, kv, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float())
    cur = _cur(cur_pos, b, q.device)[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= cur)
    if window is not None:
        valid &= slot_pos > cur - window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, h, d).to(q.dtype)


def _library():
    lib = _build.load(*BUILD)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        if lib.decode_attention_chunk() != CHUNK:
            raise RuntimeError("CHUNK differs between the wrapper and "
                               "csrc/decode_attention.cu")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_inputs(q, k_cache, v_cache, slot_pos, window) -> None:
    """Raise unless the kernel takes these inputs."""
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"want q [B,H,D] and k/v [B,S,KV,D], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    if tuple(k_cache.shape) != (b, s, kv, d) or \
            v_cache.shape != k_cache.shape:
        raise ValueError(f"k/v {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if tuple(slot_pos.shape) != (b, s) or slot_pos.dtype != torch.int32:
        raise ValueError(f"slot_pos: want int32 {(b, s)}, got "
                         f"{slot_pos.dtype} {tuple(slot_pos.shape)}")
    if s > MAX_SLOTS:
        raise ValueError(f"{s} cache slots: the kernel takes at most "
                         f"{MAX_SLOTS}")
    if min(b, s, kv) < 1 or h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"{h} heads over {kv} kv heads (at most "
                         f"{MAX_GROUP} a kv head), S={s}, B={b}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}: want one of float32, bfloat16 "
                         "for all three")
    if not (q.device == k_cache.device == v_cache.device == slot_pos.device):
        raise ValueError("q, the cache and slot_pos must be on one device")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("slot_pos", slot_pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or \
            v_cache.data_ptr() % 16:
        raise ValueError("the kernel reads q and the K/V rows as 16-byte "
                         "vectors: q, k_cache and v_cache must be 16-byte "
                         "aligned")
    if window is not None and int(window) < 1:
        raise ValueError(f"window {window} < 1")


def decode_attention_cuda(q, k_cache, v_cache, slot_pos, cur_pos, *,
                          window=None, scale=None):
    """Launch ``csrc/decode_attention.cu`` on PyTorch's current stream.

    Same contract as :func:`decode_attention_plain`.  Raises on tensors
    that are not on a CUDA device, not contiguous, of other dtypes than
    float32/bfloat16 (one for q and the cache), a head dim outside
    :data:`HEAD_DIMS`, and when the build or the launch fails.  Counts its launches
    (each a split and a combine kernel) in
    ``decode_attention_cuda.launches``."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    check_inputs(q, k_cache, v_cache, slot_pos, window)
    b, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else float(scale)
    cur = _cur(cur_pos, b, q.device)
    n_chunks = -(-s // CHUNK)
    dev = q.device
    part_m = torch.empty(b * kv * n_chunks * g, dtype=torch.float32,
                         device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(b * kv * n_chunks * g * d, dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    launch = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in
            (q, k_cache, v_cache, slot_pos, cur, part_m, part_l, part_acc,
             out)]
    rc = launch(*ptrs, b, s, h, kv, d, _DTYPES[q.dtype], scale,
                0 if window is None else int(window), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc} at q {tuple(q.shape)}, cache "
                           f"{tuple(k_cache.shape)}, {q.dtype}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
