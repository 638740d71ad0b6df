"""The ``"fused"`` step backend: evict-and-place in hand-written CUDA.

Port of ``repro.kernels.pool_step`` (the Pallas kernel
``_evict_place_kernel``).  One pass over the stacked ``[pools, slots]``
axes ranks the idle slots by counting instead of sorting,

    before_i = sum_j [ (pri_j, seq_j) <lex (pri_i, seq_i) ] * sz_j,

with ``sz_j = idle_j ? size_j : 0``, evicts ``idle_i & (before_i <
deficit - 1e-9)``, and places the new container in the first slot left
empty.  On quantized traces (whole MB) this is bitwise equal to the
sort composite ``repro_torch.core.pool._evict_place_lax``.

* :func:`evict_place_cuda` launches the hand-written kernel
  (``csrc/pool_step.cu``: one launch, a thread-block cluster per pool
  row that ranks packed ``(pri, seq)`` keys and reduces the row through
  distributed shared memory) on a CUDA tensor and raises on anything
  else;
* :func:`evict_place_plain` is the same counting formulation in plain
  torch over ``[P, S, S]``;
* :func:`pack_keys_plain` mirrors the kernel's packed key in plain torch,
  for the tests of its order;
* the registered backend :func:`fused_evict_place` takes the kernel for
  CUDA tensors and the plain version for CPU tensors, and nothing else.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from ..core.pool import _first_true, register_step_backend
from . import _build

#: Slots one row may have: every block of a row's cluster stages 14 B a
#: slot in shared memory (the packed key, the size and the slot number,
#: 56 KB at this size), and slot numbers fit 15 bits.
MAX_SLOTS = 4096
#: Pool rows one launch may have (the grid's y extent).
MAX_POOLS = 65535


def evict_place_plain(pri, seq, size, idle, valid, deficit):
    """The kernel's arithmetic in plain torch (the step-backend
    contract of ``repro_torch.core.pool``), on any device."""
    sz = torch.where(idle, size, 0.0)
    pri_i, seq_i = pri.unsqueeze(-1), seq.unsqueeze(-1)       # [P, S, 1]
    pri_j, seq_j = pri.unsqueeze(-2), seq.unsqueeze(-2)       # [P, 1, S]
    less = (pri_j < pri_i) | ((pri_j == pri_i) & (seq_j < seq_i))
    before = torch.where(less, sz.unsqueeze(-2), 0.0).sum(-1)  # [P, S]
    evict = idle & (before < (deficit - 1e-9).unsqueeze(-1))
    empty = ~(valid & ~evict)
    return (evict, torch.where(evict, size, 0.0).sum(-1),
            _first_true(empty).to(torch.int32), sz.sum(-1), empty.any(-1))


def _monotone_bits(x):
    """The f32 bits of ``x + 0.0`` (``-0.0`` becomes ``+0.0``) as int64,
    flipped so that their unsigned order is the float order."""
    u = (x.float() + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u ^ (1 << 31))


def pack_keys_plain(pri, seq):
    """The kernel's packed key in plain torch: the monotone bits of
    ``pri`` in the high word and of ``seq`` in the low word, shifted by
    2^63 so that int64's signed order is the kernel's unsigned one.  For
    non-NaN inputs ``key_j < key_i`` iff ``(pri_j, seq_j) <lex (pri_i,
    seq_i)`` under the float compare."""
    return (_monotone_bits(pri) - (1 << 31)) * (1 << 32) \
        + _monotone_bits(seq)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _library():
    lib = _build.load("pool_step")
    fn = lib.evict_place_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def evict_place_cuda(pri, seq, size, idle, valid, deficit):
    """Launch ``csrc/pool_step.cu`` on the tensors' device, on PyTorch's
    current stream of that device.

    Same contract and outputs as :func:`evict_place_plain`.  Raises on a
    tensor that is not on a CUDA device, of the wrong dtype or shape, or
    not contiguous, or on another device than ``pri``; beyond
    :data:`MAX_SLOTS` slots or :data:`MAX_POOLS` rows; and when the build
    or the launch fails.  Counts its launches in
    ``evict_place_cuda.launches`` (:func:`add_launches`)."""
    dev = pri.device
    if dev.type != "cuda":
        raise ValueError(f"evict_place_cuda needs CUDA tensors, got {dev}")
    if pri.ndim != 2:
        raise ValueError(f"pri must be [pools, slots], got {pri.shape}")
    P, S = pri.shape
    if P == 0 or S == 0:
        raise ValueError(f"empty pool batch {tuple(pri.shape)}")
    if S > MAX_SLOTS or P > MAX_POOLS:
        raise ValueError(f"[{P}, {S}]: slots exceed the kernel's "
                         f"{MAX_SLOTS} or pools its {MAX_POOLS}")
    for name, t, dt in (("pri", pri, torch.float32),
                        ("seq", seq, torch.float32),
                        ("size", size, torch.float32),
                        ("idle", idle, torch.bool),
                        ("valid", valid, torch.bool)):
        _check(name, t, dt, (P, S), dev)
    _check("deficit", deficit, torch.float32, (P,), dev)
    launch = _library()
    evict = torch.empty((P, S), dtype=torch.bool, device=dev)
    freed = torch.empty(P, dtype=torch.float32, device=dev)
    ins = torch.empty(P, dtype=torch.int32, device=dev)
    avail = torch.empty(P, dtype=torch.float32, device=dev)
    empty = torch.empty(P, dtype=torch.bool, device=dev)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = launch(_ptr(pri), _ptr(seq), _ptr(size), _ptr(idle), _ptr(valid),
                _ptr(deficit), _ptr(evict), _ptr(freed), _ptr(ins),
                _ptr(avail), _ptr(empty), P, S, index,
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"evict_place kernel launch failed: CUDA error "
                           f"{rc} at [{P}, {S}] on cuda:{index}")
    add_launches(1)
    return evict, freed, ins, avail, empty


evict_place_cuda.launches = 0
_LAUNCHES_LOCK = threading.Lock()
_tally = threading.local()


def add_launches(n: int) -> None:
    """Add ``n`` launches to ``evict_place_cuda.launches``, under a lock
    (a sharded sweep launches from one thread a device), or to this
    thread's open :func:`tally_launches` instead."""
    if getattr(_tally, "count", None) is not None:
        _tally.count += n
        return
    with _LAUNCHES_LOCK:
        evict_place_cuda.launches += n


@contextlib.contextmanager
def tally_launches():
    """Count this thread's launches apart from
    ``evict_place_cuda.launches`` (the block runner's warm-up and
    capture, which no run asked for); yields a function that reads the
    tally so far."""
    outer = getattr(_tally, "count", None)
    _tally.count = 0
    try:
        yield lambda: _tally.count
    finally:
        _tally.count = outer


@register_step_backend("fused")
def fused_evict_place(pri, seq, size, idle, valid, deficit):
    """Step-backend entry: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (and only for those)."""
    if pri.device.type == "cpu":
        return evict_place_plain(pri, seq, size, idle, valid, deficit)
    return evict_place_cuda(pri, seq, size, idle, valid, deficit)
