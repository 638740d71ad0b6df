"""The Mamba2 SSD scan (kernel B4) in hand-written CUDA, and its plain
version.

Port of ``repro.kernels.ssm_scan`` (the Pallas kernel ``_kernel``) and of
its oracle ``repro.kernels.ref.ssm_scan``: per (batch, head)
``h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t^T`` and ``y_t = C_t h_t``, with
x ``[B, S, H, P]``, dt ``[B, S, H]`` f32, a ``[H]`` f32 (negative), B/C
``[B, S, H, N]``; y in x's dtype and the final state ``[B, H, N, P]`` in
f32.

* :func:`ssm_scan_cuda` launches ``csrc/ssm_scan.cu`` (chunks of
  :data:`CHUNK` steps in the SSD matrix form, :data:`BLOCK_COLS` columns
  of P a block) on a CUDA tensor and raises on anything else: bf16 runs
  ``ssm_scan_mma_kernel`` (``mma.sync`` on the tensor cores), f32
  ``ssm_scan_fma_kernel`` (f32 FMAs on the CUDA cores);
* :func:`ssm_scan_plain` is the oracle in plain torch: the sequential
  recurrence in f32, on any device;
* :func:`ssm_scan_bwd` is its gradient in plain torch (chunked), the
  backward of the kernel's autograd Function (``kernels.ops``): the
  reference has no backward kernel;
* :func:`ssm_scan_chunked_plain` mirrors the kernels' arithmetic in plain
  torch (the same chunks and, for bf16 inputs, the same hi + lo bf16
  splits), so that the CPU tests can show the rounding choice against the
  reference; nothing on the main path calls it;
* :func:`ssm_decode_step` is the single-token update, plain torch: the
  reference has no kernel for it (``repro/kernels/ops.py``: "no kernel
  warranted").

``repro_torch.kernels.ops.ssm_scan`` takes the kernel for CUDA tensors and
the plain version for CPU tensors, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: Steps a chunk of the kernel (``T`` in the .cu).
CHUNK = 64
#: Columns of P a block takes (``PB`` in the .cu).
BLOCK_COLS = 32
#: (N, P) the kernel is built for: zamba2's (64, 64), Mamba2's own
#: (128, 64), and the reference's test shapes (32, 64) and (16, 32) (the
#: last is also reduced zamba2's).
STATE_SHAPES = ((64, 64), (128, 64), (32, 64), (16, 32))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BUILD = ("ssm_scan", _build.ATTENTION_FLAGS)


def ssm_scan_plain(x, dt, a, b, c, *, h0=None):
    """The reference oracle in torch: the recurrence a step at a time,
    in f32.  Returns (y in x's dtype, h_final f32)."""
    bsz, s, hh, p = x.shape
    n = b.shape[-1]
    h = torch.zeros(bsz, hh, n, p, dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    ys = []
    for t in range(s):
        y, h = ssm_decode_step(xf[:, t], dtf[:, t], a, bf[:, t], cf[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), h


def _hi_lo(t):
    """f32 ``t`` as the sum of its two bf16 parts, hi = bf16(t) and lo =
    bf16(t - hi), as the bf16 kernel feeds f32 operands to the tensor
    cores."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def ssm_scan_chunked_plain(x, dt, a, b, c, *, h0=None, chunk=CHUNK):
    """The kernels' arithmetic in plain torch: chunks of ``chunk`` steps in
    the SSD matrix form, the mask before the exponential, dt folded into
    G and w; for bf16 inputs G, h (in C h) and w o X pass through
    :func:`_hi_lo` before their products, as in ``ssm_scan_mma_kernel``.
    Same contract as :func:`ssm_scan_plain`; the sums run in another
    order than the kernels'."""
    bsz, s, hh, p = x.shape
    n = b.shape[-1]
    two = _hi_lo if x.dtype == torch.bfloat16 else (lambda t: t)
    xf, bf, cf = (t.float().transpose(1, 2) for t in (x, b, c))
    dtf = dt.float().transpose(1, 2)                      # [B, H, S]
    h = torch.zeros(bsz, hh, n, p, dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for t0 in range(0, s, chunk):
        xc, bc, cc = (t[:, :, t0:t0 + chunk] for t in (xf, bf, cf))
        dc = dtf[:, :, t0:t0 + chunk]
        sc = torch.cumsum(a.float()[None, :, None] * dc, dim=-1)
        tc = sc.shape[-1]
        lower = torch.ones(tc, tc, dtype=torch.bool, device=x.device).tril()
        diff = torch.where(lower, sc[..., :, None] - sc[..., None, :], 0.0)
        g = torch.where(lower, (cc @ bc.transpose(-1, -2)) * torch.exp(diff)
                        * dc[..., None, :], 0.0)
        ys.append(two(g) @ xc + torch.exp(sc)[..., None] * (cc @ two(h)))
        w = torch.exp(sc[..., -1:] - sc) * dc
        h = torch.exp(sc[..., -1])[..., None, None] * h + \
            bc.transpose(-1, -2) @ two(w[..., None] * xc)
    return torch.cat(ys, dim=2).transpose(1, 2).to(x.dtype), h


def _rev_cumsum(t, dim=-1):
    return torch.flip(torch.cumsum(torch.flip(t, (dim,)), dim), (dim,))


def ssm_scan_bwd(x, dt, a, b, c, h0, dy, dh, *, chunk=CHUNK):
    """The gradient of :func:`ssm_scan_plain` in plain torch, for the
    upstream grads ``dy`` (of y) and ``dh`` (of the final state): (dx,
    ddt, da, db, dc, dh0), each in its input's dtype (``dh0`` None when
    ``h0`` is).

    The reference has no backward kernel.  This is the reverse-time
    recurrence over the f32 state, taken a chunk of ``chunk`` steps at a
    time in the SSD matrix form (the kernel's chunks): within a chunk,
    with ``s`` the inclusive cumsum of ``a dt``, ``L[t,j] = exp(s_t -
    s_j)`` (j <= t), ``G = (C B^T) o L o dt_j``, ``w_j = exp(s_T - s_j)
    dt_j``,

        y = G X + exp(s) o (C h_in),  h_out = exp(s_T) h_in + B^T (w o X);

    the chunk states ``h_in`` are recomputed forward, the state grads
    ``dh_out`` run backward chunk by chunk (``dh_in = C^T (exp(s) o dy) +
    exp(s_T) dh_out``), and every other term is batched over the chunks.
    The grad of ``s`` folds into dt and a through a reverse cumsum.  The
    sequence is padded to whole chunks with dt = 0 (decay 1, no input)."""
    bsz, s, hh, p = x.shape
    n = b.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t, width=None):          # [B,S,H(,W)] -> [B,H,nc,T(,W)]
        t = t.float().transpose(1, 2)
        if pad:
            t = torch.nn.functional.pad(
                t, (0, 0, 0, pad) if width else (0, pad))
        return t.reshape(bsz, hh, nc, chunk, *((width,) if width else ()))
    xx, bb, cc, dyy = chunks(x, p), chunks(b, n), chunks(c, n), chunks(dy, p)
    dtt = chunks(dt)
    af = a.float()[None, :, None, None]
    sc = torch.cumsum(af * dtt, dim=-1)                    # [B,H,nc,T]
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()
    ell = torch.where(lower, torch.exp(torch.where(
        lower, sc[..., :, None] - sc[..., None, :], 0.0)), 0.0)
    m = cc @ bb.transpose(-1, -2)                          # C B^T
    wgt = ell * dtt[..., None, :]
    g = m * wgt
    es = torch.exp(sc)
    w = torch.exp(sc[..., -1:] - sc) * dtt
    dec = torch.exp(sc[..., -1])[..., None, None]          # [B,H,nc,1,1]
    hloc = bb.transpose(-1, -2) @ (w[..., None] * xx)      # [B,H,nc,N,P]
    hin = torch.empty_like(hloc)
    h = torch.zeros_like(hloc[:, :, 0]) if h0 is None else h0.float()
    for i in range(nc):
        hin[:, :, i] = h
        h = dec[:, :, i] * h + hloc[:, :, i]
    z = cc.transpose(-1, -2) @ (es[..., None] * dyy)       # [B,H,nc,N,P]
    dout = torch.empty_like(hloc)
    gh = dh.float()
    for i in reversed(range(nc)):
        dout[:, :, i] = gh
        gh = z[:, :, i] + dec[:, :, i] * gh
    dg = dyy @ xx.transpose(-1, -2)                        # [..., T, T]
    bd = bb @ dout                                         # [..., T, P]
    dx = g.transpose(-1, -2) @ dyy + w[..., None] * bd
    dm = dg * wgt
    dc = dm @ bb + es[..., None] * (dyy @ hin.transpose(-1, -2))
    db = dm.transpose(-1, -2) @ cc + w[..., None] * (xx @
                                                   dout.transpose(-1, -2))
    dw = (bd * xx).sum(-1)                                 # [B,H,nc,T]
    ddt = (dg * m * ell).sum(-2) + dw * torch.exp(sc[..., -1:] - sc)
    q = dg * g
    ds = q.sum(-1) - q.sum(-2) + es * (dyy * (cc @ hin)).sum(-1) - dw * w
    ds[..., -1] += (dw * w).sum(-1) + dec[..., 0, 0] * (dout * hin).sum(
        (-2, -1))
    rc = _rev_cumsum(ds)
    ddt = ddt + af * rc
    da = (rc * dtt).sum((0, 2, 3))

    def back(t, like):                  # [B,H,nc,T(,W)] -> like's layout
        t = t.reshape(bsz, hh, nc * chunk, *t.shape[4:])[:, :, :s]
        return t.transpose(1, 2).to(like.dtype)
    return (back(dx, x), back(ddt, dt), da.to(a.dtype), back(db, b),
            back(dc, c), None if h0 is None else gh.to(h0.dtype))


def ssm_decode_step(x, dt, a, b, c, h):
    """Single-token SSM update (``repro.kernels.ref.ssm_decode_step``).
    x [B,H,P], dt [B,H] f32, b/c [B,H,N], h [B,H,N,P] -> (y [B,H,P] in x's
    dtype, h' f32)."""
    decay = torch.exp(a[None] * dt)[..., None, None]
    h = decay * h.float() + (
        b[..., None] * (dt[..., None] * x)[..., None, :]).float()
    y = torch.einsum("bhn,bhnp->bhp", c.float(), h)
    return y.to(x.dtype), h


def _library():
    lib = _build.load(*BUILD)
    fn = lib.ssm_scan_launch
    if fn.argtypes is None:
        if (lib.ssm_scan_chunk(), lib.ssm_scan_block_cols()) != \
                (CHUNK, BLOCK_COLS):
            raise RuntimeError("CHUNK or BLOCK_COLS differs between the "
                               "wrapper and csrc/ssm_scan.cu")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_inputs(x, dt, a, b, c, h0) -> None:
    """Raise unless the kernel takes these inputs."""
    if x.ndim != 4 or b.ndim != 4:
        raise ValueError(f"want x [B,S,H,P] and b/c [B,S,H,N], got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}")
    bsz, s, hh, p = x.shape
    n = b.shape[-1]
    if tuple(b.shape) != (bsz, s, hh, n) or c.shape != b.shape:
        raise ValueError(f"b/c {tuple(b.shape)}, {tuple(c.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if tuple(dt.shape) != (bsz, s, hh) or tuple(a.shape) != (hh,):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}: want "
                         f"{(bsz, s, hh)} and {(hh,)}")
    if min(bsz, s, hh) < 1:
        raise ValueError(f"empty scan: B={bsz}, S={s}, H={hh}")
    if (n, p) not in STATE_SHAPES:
        raise ValueError(f"state (N, P) = {(n, p)}: the kernel takes "
                         f"{STATE_SHAPES}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {b.dtype}, {c.dtype}: want one "
                         "of float32, bfloat16 for x, b and c")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"dt {dt.dtype} and a {a.dtype} must be float32")
    tensors = [("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)]
    if h0 is not None:
        if tuple(h0.shape) != (bsz, hh, n, p) or h0.dtype != torch.float32:
            raise ValueError(f"h0: want float32 {(bsz, hh, n, p)}, got "
                             f"{h0.dtype} {tuple(h0.shape)}")
        tensors.append(("h0", h0))
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("x, dt, a, b, c and h0 must be on one device")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16 or b.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError("the kernel copies x, b and c in 16-byte vectors: "
                         "they must be 16-byte aligned")


def ssm_scan_cuda(x, dt, a, b, c, *, h0=None):
    """Launch ``csrc/ssm_scan.cu`` on PyTorch's current stream.

    Same contract as :func:`ssm_scan_plain`.  Raises on tensors that are
    not on a CUDA device, not contiguous or (x, b, c) not 16-byte aligned,
    on x/b/c of other dtypes than float32/bfloat16 (one for all three),
    dt/a/h0 other than float32, an (N, P) outside :data:`STATE_SHAPES`,
    and when the build or the launch fails.  Counts its launches in
    ``ssm_scan_cuda.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_cuda needs CUDA tensors, got {x.device}")
    check_inputs(x, dt, a, b, c, h0)
    bsz, s, hh, p = x.shape
    n = b.shape[-1]
    launch = _library()
    y = torch.empty_like(x)
    h_out = torch.empty(bsz, hh, n, p, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [None if t is None else ctypes.c_void_p(t.data_ptr())
            for t in (x, dt, a, b, c, h0, y, h_out)]
    rc = launch(*ptrs, bsz, s, hh, n, p, _DTYPES[x.dtype],
                ctypes.c_void_p(stream))
    if rc != 0:
        what = "not built for it" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"ssm_scan kernel launch failed: {what} at x "
                           f"{tuple(x.shape)}, N={n}, {x.dtype}")
    ssm_scan_cuda.launches += 1
    return y, h_out


ssm_scan_cuda.launches = 0
