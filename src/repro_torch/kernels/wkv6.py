"""The RWKV6 WKV recurrence (kernel B5) in hand-written CUDA, and its
plain version.

Port of ``repro.kernels.wkv6`` (the Pallas kernel ``_kernel``) and of its
oracle ``repro.kernels.ref.wkv6``: per (batch, head), with a state S
``[D, D]`` (k-dim x v-dim) in f32,
``y_t = r_t (S + diag(u) k_t^T v_t)`` and
``S <- diag(exp(-exp(w_t))) S + k_t^T v_t``; r/k/v/w ``[B, S, H, D]``,
u ``[H, D]``; y in r's dtype, the final state ``[B, H, D, D]`` in f32.

* :func:`wkv6_cuda` launches ``csrc/wkv6.cu`` on a CUDA tensor (any S,
  S = 1 included: the rwkv6 model runs it on every decode step) and
  raises on anything else;
* :func:`wkv6_plain` is the oracle in plain torch: sequential, in f32,
  on any device;
* :func:`wkv6_bwd` is its gradient in plain torch, the backward of the
  kernel's autograd Function (``kernels.ops``): the reference has no
  backward kernel;
* :func:`wkv6_decode_step` is the reference's single-token update in
  plain torch, kept for parity with ``repro.kernels.ops``; the rwkv6
  model does not call it (nor does the reference's).

``repro_torch.kernels.ops.wkv6`` takes the kernel for CUDA tensors and the
plain version for CPU tensors, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: The head dim the kernel is built for (``D`` in the .cu).
HEAD_DIM = 64
#: Steps the kernel stages and reduces y over at a time (``TC`` in the .cu).
CHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BUILD = ("wkv6", _build.ATTENTION_FLAGS)


def _step(rt, kt, vt, wt, u, state):
    """One step on f32 [B,H,D] inputs: (y_t [B,H,D], the new state)."""
    decay = torch.exp(-torch.exp(wt))
    kv = kt[..., :, None] * vt[..., None, :]                   # [B,H,D,D]
    y = torch.einsum("bhd,bhde->bhe", rt, state + u[None, :, :, None] * kv)
    return y, decay[..., None] * state + kv


def wkv6_plain(r, k, v, w, u, *, state=None):
    """The reference oracle in torch, a step at a time in f32.  Returns
    (y in r's dtype, the final state f32)."""
    bsz, s, h, d = r.shape
    st = torch.zeros(bsz, h, d, d, dtype=torch.float32, device=r.device) \
        if state is None else state
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    ys = []
    for t in range(s):
        y, st = _step(rf[:, t], kf[:, t], vf[:, t], wf[:, t], u, st)
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), st


def wkv6_bwd(r, k, v, w, u, state, dy, dstate):
    """The gradient of :func:`wkv6_plain` in plain torch, for the upstream
    grads ``dy`` (of y) and ``dstate`` (of the final state): (dr, dk, dv,
    dw, du, dstate0), each in its input's dtype (``dstate0`` None when
    ``state`` is).

    The reference has no backward kernel.  This is the reverse-time
    recurrence, in f32: the states ``S_{t-1}`` are recomputed forward,
    then ``gS_{t-1} = diag(lam_t) gS_t + r_t^T dy_t`` runs backward from
    ``dstate`` (``lam = exp(-exp(w))``), one step an op pair; the rest is
    batched over the steps:

        dr_t = S_{t-1} dy_t + u o k_t (v_t . dy_t)
        dkv_t = gS_t + (r_t o u)^T dy_t,  dk_t = dkv_t v_t,  dv_t = k_t dkv_t
        dw_t = -exp(w_t) lam_t o rowsum(gS_t o S_{t-1})
        du = sum_t r_t o k_t (v_t . dy_t)

    Holds two f32 ``[B, S, H, D, D]`` tensors (the states and their
    grads)."""
    bsz, s, h, d = r.shape
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()
    ew = torch.exp(wf)
    lam = torch.exp(-ew)[..., None]                        # [B,S,H,D,1]
    kv = kf[..., :, None] * vf[..., None, :]               # [B,S,H,D,D]
    prev = torch.empty_like(kv)
    st = torch.zeros_like(kv[:, 0]) if state is None else state.float()
    for t in range(s):
        prev[:, t] = st
        st = torch.addcmul(kv[:, t], lam[:, t], st)
    gs = kv                                  # reuse: gS_t overwrites k v
    rdy = rf[..., :, None] * dyf[..., None, :]
    g = dstate.float()
    for t in reversed(range(s)):
        gs[:, t] = g
        g = torch.addcmul(rdy[:, t], lam[:, t], g)
    vdy = (vf * dyf).sum(-1, keepdim=True)                 # [B,S,H,1]
    dr = torch.einsum("bshde,bshe->bshd", prev, dyf) + uf * kf * vdy
    du = (rf * kf * vdy).sum((0, 1))
    dkv = torch.add(gs, (rf * uf)[..., :, None] * dyf[..., None, :],
                    out=rdy)
    dk = torch.einsum("bshde,bshe->bshd", dkv, vf)
    dv = torch.einsum("bshde,bshd->bshe", dkv, kf)
    dw = -ew * lam[..., 0] * (gs * prev).sum(-1)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), None if state is None else g.to(state.dtype))


def wkv6_decode_step(r, k, v, w, u, state):
    """Single-token WKV update (``repro.kernels.ref.wkv6_decode_step``).
    r/k/v/w [B,H,D], state [B,H,D,D] f32 -> (y [B,H,D] in r's dtype,
    state')."""
    y, state = _step(*(t.float() for t in (r, k, v, w)), u, state)
    return y.to(r.dtype), state


def _library():
    lib = _build.load(*BUILD)
    fn = lib.wkv6_launch
    if fn.argtypes is None:
        if (lib.wkv6_head_dim(), lib.wkv6_chunk()) != (HEAD_DIM, CHUNK):
            raise RuntimeError("HEAD_DIM or CHUNK differs between the "
                               "wrapper and csrc/wkv6.cu")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_inputs(r, k, v, w, u, state) -> None:
    """Raise unless the kernel takes these inputs."""
    if r.ndim != 4:
        raise ValueError(f"want r/k/v/w [B,S,H,D], got {tuple(r.shape)}")
    bsz, s, h, d = r.shape
    if any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r/k/v/w shapes differ: {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    if min(bsz, s, h) < 1:
        raise ValueError(f"empty recurrence: B={bsz}, S={s}, H={h}")
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIM}")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise ValueError(f"dtypes {r.dtype}, {k.dtype}, {v.dtype}, "
                         f"{w.dtype}: want one of float32, bfloat16 for all "
                         "four")
    if tuple(u.shape) != (h, d) or u.dtype != torch.float32:
        raise ValueError(f"u: want float32 {(h, d)}, got {u.dtype} "
                         f"{tuple(u.shape)}")
    tensors = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if state is not None:
        if tuple(state.shape) != (bsz, h, d, d) or \
                state.dtype != torch.float32:
            raise ValueError(f"state: want float32 {(bsz, h, d, d)}, got "
                             f"{state.dtype} {tuple(state.shape)}")
        tensors.append(("state", state))
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("r, k, v, w, u and state must be on one device")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tensors[:4]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "copies 16-byte vectors)")


def wkv6_cuda(r, k, v, w, u, *, state=None):
    """Launch ``csrc/wkv6.cu`` on PyTorch's current stream.

    Same contract as :func:`wkv6_plain`.  Raises on tensors that are not
    on a CUDA device, not contiguous or (r/k/v/w) not 16-byte aligned, on
    r/k/v/w of other dtypes than float32/bfloat16 (one for all four), u or
    the state other than float32, a head dim other than 64, and when the
    build or the launch fails.  Counts its launches in
    ``wkv6_cuda.launches``."""
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_cuda needs CUDA tensors, got {r.device}")
    check_inputs(r, k, v, w, u, state)
    bsz, s, h, d = r.shape
    launch = _library()
    y = torch.empty_like(r)
    s_out = torch.empty(bsz, h, d, d, dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = [None if t is None else ctypes.c_void_p(t.data_ptr())
            for t in (r, k, v, w, u, state, y, s_out)]
    rc = launch(*ptrs, bsz, s, h, _DTYPES[r.dtype], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc} at "
                           f"r {tuple(r.shape)}, {r.dtype}")
    wkv6_cuda.launches += 1
    return y, s_out


wkv6_cuda.launches = 0
