"""Flash attention (prefill) in hand-written CUDA, and its plain version.

Port of ``repro.kernels.flash_attention`` (the Pallas kernel ``_kernel``)
and of its oracle ``repro.kernels.ref.flash_attention``: masked
multi-head attention with GQA, q ``[B, Sq, H, D]`` against k/v
``[B, Skv, KV, D]`` (query head ``h`` reads kv head ``h // (H // KV)``),
causal with query position ``q_offset + i``, and optionally only the last
``window`` keys.

* :func:`flash_attention_cuda` launches ``csrc/flash_attention.cu`` on a
  CUDA tensor and raises on anything else: bf16 runs
  ``flash_wgmma_kernel`` (``wgmma`` on the tensor cores, K/V tiles by
  TMA), f32 runs ``flash_fma_kernel`` (f32 FMAs on the CUDA cores, which
  the f32 tolerance of 2e-5 needs: TF32 tensor cores keep ~3 digits);
* :func:`flash_attention_plain` is the oracle in plain torch,
  query-chunked as the reference's is, on any device;
* :func:`flash_attention_bwd` is its gradient in plain torch, the
  backward of the kernel's autograd Function (``kernels.ops``): the
  reference has no backward kernel.

``repro_torch.kernels.ops.flash_attention`` takes the kernel for CUDA
tensors and the plain version for CPU tensors, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
#: Head dims the kernel is built for: 64 and 128, and kimi-k2's 112 (its
#: bf16 tiles are zero-padded to 128 columns inside the kernel).
HEAD_DIMS = (64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BUILD = ("flash_attention", _build.ATTENTION_FLAGS)


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None,
                          q_offset=0, chunk=1024):
    """The reference oracle in torch: scores in f32 (q pre-scaled in its
    own dtype), a ``NEG_INF`` mask, softmax in f32, weights cast to v's
    dtype for the value product, result in q's dtype.  Queries go in
    chunks of ``chunk`` rows so no ``Sq x Skv`` score tensor is built at
    once."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    qr = q.reshape(b, sq, kv, g, d)
    kpos = torch.arange(skv, device=q.device)
    kf = k.float()
    out = []
    for c0 in range(0, sq, chunk):
        qc = qr[:, c0:c0 + chunk]
        qpos = torch.arange(c0, c0 + qc.shape[1], device=q.device) + q_offset
        s = torch.einsum("bqkgd,bskd->bkgqs", (qc * scale).float(), kf)
        mask = torch.ones(qc.shape[1], skv, dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
        out.append(o.reshape(b, qc.shape[1], h, d))
    return torch.cat(out, dim=1).to(q.dtype)


def flash_attention_bwd(q, k, v, do, *, causal=True, window=None,
                        scale=None, q_offset=0, chunk=1024):
    """The gradient of :func:`flash_attention_plain` in plain torch:
    (dq, dk, dv) in the inputs' dtypes for the upstream grad ``do``.

    The reference has no backward kernel, so this is the standard
    softmax-attention gradient, recomputed from q, k and v a chunk of
    ``chunk`` queries at a time: scores and softmax in f32 as the forward
    takes them (q scaled in its own dtype), ``dP = dO V^T``,
    ``dS = P (dP - rowsum(P dP))``, then ``dq = dS K scale``,
    ``dk = dS^T (q scale)``, ``dv = P^T dO``, summed over the query heads
    of each kv head (GQA).  Every product runs in f32."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    qs = (q * scale).reshape(b, sq, kv, g, d).float()
    dor = do.reshape(b, sq, kv, g, d).float()
    kpos = torch.arange(skv, device=q.device)
    kf, vf = k.float(), v.float()
    dk = torch.zeros(b, skv, kv, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq = []
    for c0 in range(0, sq, chunk):
        qc, dc = qs[:, c0:c0 + chunk], dor[:, c0:c0 + chunk]
        qpos = torch.arange(c0, c0 + qc.shape[1], device=q.device) + q_offset
        s = torch.einsum("bqkgd,bskd->bkgqs", qc, kf)
        mask = torch.ones(qc.shape[1], skv, dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dc, vf)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dv += torch.einsum("bkgqs,bqkgd->bskd", p, dc)
        dk += torch.einsum("bkgqs,bqkgd->bskd", ds, qc)
        dq.append(torch.einsum("bkgqs,bskd->bqkgd", ds, kf)
                  .reshape(b, qc.shape[1], h, d))
    dq = torch.cat(dq, dim=1) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _library():
    fn = _build.load(*BUILD).flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_inputs(q, k, v, causal, window, q_offset) -> None:
    """Raise unless the kernel takes these inputs."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"want q [B,Sq,H,D] and k/v [B,Skv,KV,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape
    if tuple(k.shape) != (b, skv, kv, d) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if min(b, sq, skv, kv) < 1 or h % kv:
        raise ValueError(f"{h} heads over {kv} kv heads, Sq={sq}, "
                         f"Skv={skv}, B={b}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want "
                         "one of float32, bfloat16 for all three")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "reads 16-byte vectors)")
    if int(q_offset) < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if window is not None and int(window) < 1:
        raise ValueError(f"window {window} < 1")
    # the last query row must see a key (causal rows always see key 0)
    if window is not None and q_offset + sq - window > skv - 1:
        raise ValueError("a query row sees no key: q_offset + Sq - window "
                         f"= {q_offset + sq - window} > Skv - 1")


def flash_attention_cuda(q, k, v, *, causal=True, window=None, scale=None,
                         q_offset=0):
    """Launch ``csrc/flash_attention.cu`` on PyTorch's current stream.

    Same contract as :func:`flash_attention_plain`.  Raises on tensors
    that are not on a CUDA device, not contiguous, of other dtypes than
    float32/bfloat16 (one for all three), a head dim outside
    :data:`HEAD_DIMS`,
    a query row that would see no key, and when the build, a tensor map
    (bf16) or the launch fails.  Counts its launches in
    ``flash_attention_cuda.launches``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    check_inputs(q, k, v, causal, window, q_offset)
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    launch = _library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = launch(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
                ctypes.c_void_p(v.data_ptr()),
                ctypes.c_void_p(out.data_ptr()), b, sq, skv, h, kv, d,
                _DTYPES[q.dtype], scale, int(bool(causal)),
                0 if window is None else int(window), int(q_offset),
                ctypes.c_void_p(stream))
    if rc != 0:
        what = (f"the driver refused a tensor map (CUresult {-rc - 1000})"
                if rc <= -1000 else
                "the driver has no cuTensorMapEncodeTiled" if rc == -2 else
                f"CUDA error {rc}")
        raise RuntimeError(f"flash_attention kernel launch failed: {what} "
                           f"at q {tuple(q.shape)}, kv {tuple(k.shape)}, "
                           f"{q.dtype}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
