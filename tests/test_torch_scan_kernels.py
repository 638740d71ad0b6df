"""Kernels B4 (the Mamba2 SSD scan) and B5 (the RWKV6 WKV recurrence) of
the PyTorch port.

On the CPU the port's plain versions are held against the reference's
oracles (``repro.kernels.ref``) and its Pallas kernels in interpret mode,
as ``tests/test_kernels.py`` runs them.  Tolerances, each with its reason:

* plain against the oracle, f32: 1e-5 absolute and relative.  Both run
  the same sequential recurrence in f32 and differ only in the order of
  the sums inside a step and in the last ulp of ``exp``.
* plain against Pallas (interpret), f32: the reference's own bound for
  its chunked kernel against its sequential oracle, atol 5e-4 and rtol
  1e-3 (``tests/test_kernels.py``): the chunked form sums in another
  order.
* bf16 inputs: 2e-2, the reference's ``TOL`` for bf16; y is rounded to
  bf16 on both sides.

``ssm_scan_chunked_plain``, the plain mirror of B4's arithmetic (its
chunks and, in bf16, its hi + lo splits of G, h and w o X), is held
against the oracle and the Pallas kernel at the same bounds, so the
rounding choice is shown on the CPU.

On the card (marker ``cuda``) each CUDA kernel is held against its plain
version, f32 at the chunked bound and bf16 at 2e-2.  The reference is
imported inside fixtures, so the file also collects where JAX is absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import (CHUNK, STATE_SHAPES,
                                          ssm_decode_step,
                                          ssm_scan_chunked_plain,
                                          ssm_scan_cuda, ssm_scan_plain)
from repro_torch.kernels.ssm_scan import check_inputs as ssm_check
from repro_torch.kernels.wkv6 import CHUNK as WKV_CHUNK
from repro_torch.kernels.wkv6 import (wkv6_cuda, wkv6_decode_step,
                                      wkv6_plain)
from repro_torch.kernels.wkv6 import check_inputs as wkv_check

SEQ_TOL = dict(atol=1e-5, rtol=1e-5)
CHUNKED_TOL = dict(atol=5e-4, rtol=1e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module")
def ref():
    """The reference's oracles and Pallas kernels (interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as oracle
    from repro.kernels.ssm_scan import ssm_scan_pallas
    from repro.kernels.wkv6 import wkv6_pallas
    return dict(jnp=jnp, oracle=oracle, ssm_pallas=ssm_scan_pallas,
                wkv_pallas=wkv6_pallas)


def ssm_inputs(seed, b, s, h, p, n, h0=False, strong=False):
    """The reference test's distributions: softplus dt, a = -exp(0.5 z),
    B and C at 0.3, h0 at 0.2.  ``strong``: a = -16 (zamba2's strongest
    head), dt at 4 softplus(z) and h0 at 10, so that exp(s) underflows
    within a chunk and a large state meets it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bb = (rng.standard_normal((b, s, h, n)) * 0.3).astype(np.float32)
    cc = (rng.standard_normal((b, s, h, n)) * 0.3).astype(np.float32)
    hh = (rng.standard_normal((b, h, n, p)) * 0.2).astype(np.float32) \
        if h0 else None
    if strong:
        a = np.full(h, -16.0, np.float32)
        dt = dt * np.float32(4.0)
        hh = None if hh is None else hh * np.float32(50.0)
    return x, dt, a, bb, cc, hh


def wkv_inputs(seed, b, s, h, d, state=False):
    """The reference test's distributions: r/k/v at 0.5, w ~ 0.5 z - 1,
    u at 0.3, a state at 0.2."""
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
               for _ in range(3))
    w = (rng.standard_normal((b, s, h, d)) * 0.5 - 1.0).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((b, h, d, d)) * 0.2).astype(np.float32) \
        if state else None
    return r, k, v, w, u, st


def tt(a, dtype=torch.float32, device="cpu"):
    return None if a is None else \
        torch.from_numpy(np.ascontiguousarray(a)).to(device).to(dtype)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def as_np(t):
    return t.detach().float().cpu().numpy()


def ssm_torch(arrays, dtype=torch.float32, device="cpu"):
    """x, b, c in ``dtype``; dt, a and h0 in f32."""
    x, dt, a, bb, cc, hh = arrays
    return (tt(x, dtype, device), tt(dt, device=device),
            tt(a, device=device), tt(bb, dtype, device),
            tt(cc, dtype, device)), tt(hh, device=device)


def wkv_torch(arrays, dtype=torch.float32, device="cpu"):
    """r, k, v, w in ``dtype``; u and the state in f32."""
    r, k, v, w, u, st = arrays
    return tuple(tt(t, dtype, device) for t in (r, k, v, w)) + \
        (tt(u, device=device),), tt(st, device=device)


def jx(ref, arrays, dtype="float32"):
    """The same arrays for JAX, each in ``dtype``."""
    jnp = ref["jnp"]
    return [None if a is None else jnp.asarray(a, getattr(jnp, dtype))
            for a in arrays]


# ---------------------------------------------------------------------------
# B4: the Mamba2 SSD scan
# ---------------------------------------------------------------------------

SSM_CASES = {   # name: (b, s, h, p, n, h0)
    "ragged": (2, 100, 3, 32, 16, False),
    "zamba2-head": (1, 37, 2, 64, 64, True),
    "one-step": (2, 1, 4, 32, 16, True),
}


@pytest.mark.parametrize("case", sorted(SSM_CASES))
def test_ssm_plain_matches_reference_oracle(case, ref):
    arrays = ssm_inputs(0, *SSM_CASES[case])
    args, h0 = ssm_torch(arrays)
    y, h = ssm_scan_plain(*args, h0=h0)
    x, dt, a, bb, cc, hh = jx(ref, arrays)
    ye, he = ref["oracle"].ssm_scan(x, dt, a, bb, cc, h0=hh)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    close(as_np(y), ye, SEQ_TOL)
    close(as_np(h), he, SEQ_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,h0", [
    (2, 256, 4, 64, 32, 64, False),
    (1, 128, 2, 32, 16, 128, False),     # single chunk
    (1, 128, 2, 32, 16, 64, True),       # with an initial state
])
def test_ssm_plain_matches_pallas_interpret(b, s, h, p, n, chunk, h0, ref):
    arrays = ssm_inputs(1, b, s, h, p, n, h0)
    args, t_h0 = ssm_torch(arrays)
    y, hf = ssm_scan_plain(*args, h0=t_h0)
    x, dt, a, bb, cc, hh = jx(ref, arrays)
    ye, he = ref["ssm_pallas"](x, dt, a, bb, cc, h0=hh, interpret=True,
                               chunk=chunk)
    close(as_np(y), ye, CHUNKED_TOL)
    close(as_np(hf), he, CHUNKED_TOL)


def test_ssm_plain_bf16_matches_reference_oracle(ref):
    """x, B and C in bf16 (as at full width), dt and a in f32: y comes
    back in bf16, h in f32."""
    arrays = ssm_inputs(2, 2, 70, 3, 64, 64, h0=True)
    args, h0 = ssm_torch(arrays, torch.bfloat16)
    y, h = ssm_scan_plain(*args, h0=h0)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    x, dt, a, bb, cc, hh = arrays
    jnp = ref["jnp"]
    ye, he = ref["oracle"].ssm_scan(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(a),
        jnp.asarray(bb, jnp.bfloat16), jnp.asarray(cc, jnp.bfloat16),
        h0=jnp.asarray(hh))
    close(as_np(y), ye, BF16_TOL)
    close(as_np(h), he, BF16_TOL)


CHUNKED_CASES = {   # name: (b, s, h, p, n, h0, strong)
    "ragged": (2, 100, 3, 32, 16, True, False),
    "zamba2-prefill": (1, 32, 2, 64, 64, False, False),
    "chunk-plus-1": (1, CHUNK + 1, 2, 64, 32, True, False),
    "mamba2-state": (1, 70, 2, 64, 128, True, False),
    "strong-decay": (1, 2 * CHUNK + 5, 2, 64, 64, True, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CHUNKED_CASES))
def test_ssm_chunked_plain_matches_reference_oracle(case, dtype, ref):
    """The kernels' chunked arithmetic (in bf16 with its hi + lo splits)
    against the reference's sequential oracle: f32 at the reference's
    chunked bound, bf16 at its ``TOL`` (x, B and C rounded to bf16 on
    both sides)."""
    arrays = ssm_inputs(14, *CHUNKED_CASES[case])
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    args, h0 = ssm_torch(arrays, tdt)
    y, h = ssm_scan_chunked_plain(*args, h0=h0)
    assert y.dtype == tdt and h.dtype == torch.float32
    jnp = ref["jnp"]
    x, dt, a, bb, cc, hh = arrays
    ye, he = ref["oracle"].ssm_scan(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(dt), jnp.asarray(a),
        jnp.asarray(bb, getattr(jnp, dtype)),
        jnp.asarray(cc, getattr(jnp, dtype)),
        h0=None if hh is None else jnp.asarray(hh))
    tol = CHUNKED_TOL if dtype == "float32" else BF16_TOL
    close(as_np(y), ye, tol)
    close(as_np(h), he, tol)


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_chunked_plain_matches_pallas_interpret(chunk, dtype, ref):
    """Against the Pallas kernel in interpret mode, whose chunks are 64
    or 128 steps, at the reference's bounds for each dtype."""
    arrays = ssm_inputs(15, 1, 256, 2, 64, 64, True)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    args, h0 = ssm_torch(arrays, tdt)
    y, h = ssm_scan_chunked_plain(*args, h0=h0)
    ye, he = ref["ssm_pallas"](*jx(ref, arrays[:5], dtype)[:1],
                               *jx(ref, arrays[1:3]),
                               *jx(ref, arrays[3:5], dtype),
                               h0=jx(ref, arrays[5:])[0], interpret=True,
                               chunk=chunk)
    tol = CHUNKED_TOL if dtype == "float32" else BF16_TOL
    close(as_np(y), ye, tol)
    close(as_np(h), he, tol)


def test_ssm_chunked_plain_bf16_split_is_what_holds_it():
    """A control for the test above: the same chunks with G, h and w o X
    each rounded once to bf16 (no lo part) drift further from the
    sequential recurrence than the hi + lo split does, at a long
    sequence with a state."""
    import repro_torch.kernels.ssm_scan as mod
    args, h0 = ssm_torch(ssm_inputs(16, 1, 4 * CHUNK, 2, 64, 64, True),
                         torch.bfloat16)
    _, want = ssm_scan_plain(*args, h0=h0)
    _, split = ssm_scan_chunked_plain(*args, h0=h0)
    hi_lo = mod._hi_lo
    try:
        mod._hi_lo = lambda t: t.to(torch.bfloat16).float()
        _, once = ssm_scan_chunked_plain(*args, h0=h0)
    finally:
        mod._hi_lo = hi_lo
    err_split = float((split - want).abs().max())
    err_once = float((once - want).abs().max())
    assert err_split < 1e-3 < err_once


def test_ssm_chunked_plain_state_continuation():
    """Two parts with the state carried, split off the chunk grid, ==
    one pass over the whole: the chunks' boundaries move and h carries
    across them."""
    args, h0 = ssm_torch(ssm_inputs(19, 1, 2 * CHUNK + 22, 2, 64, 64, True))
    y_full, h_full = ssm_scan_chunked_plain(*args, h0=h0)
    cut = CHUNK + 7
    first = [t[:, :cut] for t in args[:2]] + [args[2]] + \
        [t[:, :cut] for t in args[3:]]
    second = [t[:, cut:] for t in args[:2]] + [args[2]] + \
        [t[:, cut:] for t in args[3:]]
    y1, h1 = ssm_scan_chunked_plain(*first, h0=h0)
    y2, h2 = ssm_scan_chunked_plain(*second, h0=h1)
    close(as_np(torch.cat([y1, y2], 1)), as_np(y_full), SEQ_TOL)
    close(as_np(h2), as_np(h_full), SEQ_TOL)


def test_ssm_decode_step_matches_reference(ref):
    x, dt, a, bb, cc, hh = ssm_inputs(3, 2, 1, 4, 32, 16, h0=True)
    args = (x[:, 0], dt[:, 0], a, bb[:, 0], cc[:, 0], hh)
    y, h = ssm_decode_step(*(tt(t) for t in args))
    ye, he = ref["oracle"].ssm_decode_step(*jx(ref, args))
    close(as_np(y), ye, SEQ_TOL)
    close(as_np(h), he, SEQ_TOL)
    # one decode step is the scan of one token
    ys, hs = ssm_scan_plain(*(tt(t) for t in (x, dt, a, bb, cc)),
                            h0=tt(hh))
    close(as_np(y), as_np(ys[:, 0]), SEQ_TOL)
    close(as_np(h), as_np(hs), SEQ_TOL)


# ---------------------------------------------------------------------------
# B5: the RWKV6 WKV recurrence
# ---------------------------------------------------------------------------

WKV_CASES = {   # name: (b, s, h, d, state)
    "rwkv6-heads": (2, 45, 3, 64, False),
    "state-in": (1, 20, 2, 64, True),
    "one-step": (2, 1, 4, 64, True),
    "narrow": (1, 33, 2, 32, False),
}


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv6_plain_matches_reference_oracle(case, ref):
    arrays = wkv_inputs(4, *WKV_CASES[case])
    args, st = wkv_torch(arrays)
    y, s = wkv6_plain(*args, state=st)
    r, k, v, w, u, st0 = jx(ref, arrays)
    ye, se = ref["oracle"].wkv6(r, k, v, w, u, state=st0)
    close(as_np(y), ye, SEQ_TOL)
    close(as_np(s), se, SEQ_TOL)


@pytest.mark.parametrize("b,s,h,d,chunk", [
    (2, 128, 2, 64, 64),
    (1, 64, 4, 32, 32),
    (1, 128, 1, 64, 128),   # single chunk
])
def test_wkv6_plain_matches_pallas_interpret(b, s, h, d, chunk, ref):
    arrays = wkv_inputs(5, b, s, h, d)
    args, _ = wkv_torch(arrays)
    y, sf = wkv6_plain(*args)
    ye, se = ref["wkv_pallas"](*jx(ref, arrays[:5]), interpret=True,
                               chunk=chunk)
    close(as_np(y), ye, CHUNKED_TOL)
    close(as_np(sf), se, CHUNKED_TOL)


def test_wkv6_plain_state_continuation():
    """Two halves with the state carried == one pass over the whole."""
    args, _ = wkv_torch(wkv_inputs(6, 1, 50, 2, 64))
    y_full, s_full = wkv6_plain(*args)
    first = [t[:, :23] for t in args[:4]] + [args[4]]
    second = [t[:, 23:] for t in args[:4]] + [args[4]]
    y1, st = wkv6_plain(*first)
    y2, s2 = wkv6_plain(*second, state=st)
    close(as_np(torch.cat([y1, y2], 1)), as_np(y_full), SEQ_TOL)
    close(as_np(s2), as_np(s_full), SEQ_TOL)


def test_wkv6_plain_bf16_matches_reference_oracle(ref):
    """r/k/v/w in bf16 (the model casts w to the compute dtype), u and
    the state in f32."""
    arrays = wkv_inputs(7, 2, 40, 2, 64, state=True)
    args, st = wkv_torch(arrays, torch.bfloat16)
    y, s = wkv6_plain(*args, state=st)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    jnp = ref["jnp"]
    ye, se = ref["oracle"].wkv6(*jx(ref, arrays[:4], "bfloat16"),
                                jnp.asarray(arrays[4]),
                                state=jnp.asarray(arrays[5]))
    close(as_np(y), ye, BF16_TOL)
    close(as_np(s), se, BF16_TOL)


def test_wkv6_decode_step_matches_reference(ref):
    r, k, v, w, u, st = wkv_inputs(8, 2, 1, 3, 64, state=True)
    args = (r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, st)
    y, s = wkv6_decode_step(*(tt(t) for t in args))
    ye, se = ref["oracle"].wkv6_decode_step(*jx(ref, args))
    close(as_np(y), ye, SEQ_TOL)
    close(as_np(s), se, SEQ_TOL)


# ---------------------------------------------------------------------------
# routing and input checks
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_only():
    sargs, h0 = ssm_torch(ssm_inputs(9, 1, 5, 2, 32, 16))
    wargs, _ = wkv_torch(wkv_inputs(9, 1, 5, 2, 64))
    before = (ssm_scan_cuda.launches, wkv6_cuda.launches)
    y, _ = ops.ssm_scan(*sargs)
    close(as_np(y), as_np(ssm_scan_plain(*sargs)[0]), SEQ_TOL)
    y, _ = ops.wkv6(*wargs)
    close(as_np(y), as_np(wkv6_plain(*wargs)[0]), SEQ_TOL)
    assert (ssm_scan_cuda.launches, wkv6_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssm_scan_cuda(*sargs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv6_cuda(*wargs)
    with pytest.raises(ValueError, match="no ssm_scan"):
        ops.ssm_scan(*(t.to("meta") for t in sargs))
    with pytest.raises(ValueError, match="no wkv6"):
        ops.wkv6(*(t.to("meta") for t in wargs))


def test_kernel_input_checks():
    """What the wrappers refuse, checked before any launch."""
    (x, dt, a, b, c), _ = ssm_torch(ssm_inputs(10, 1, 8, 2, 64, 64),
                                    torch.bfloat16)
    ssm_check(x, dt, a, b, c, None)
    assert (128, 64) in STATE_SHAPES        # Mamba2's own d_state, headdim
    (x2, dt2, a2, b2, c2), _ = ssm_torch(ssm_inputs(10, 1, 8, 2, 64, 128),
                                         torch.bfloat16)
    ssm_check(x2, dt2, a2, b2, c2, None)
    with pytest.raises(ValueError, match=r"\(N, P\)"):
        ssm_check(x[..., :48].contiguous(), dt, a, b, c, None)
    odd = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        ssm_check(odd, dt, a, b, c, None)
    with pytest.raises(ValueError, match="dtypes"):
        ssm_check(x, dt, a, b.float(), c, None)
    with pytest.raises(ValueError, match="float32"):
        ssm_check(x, dt.bfloat16(), a, b, c, None)
    with pytest.raises(ValueError, match="h0"):
        ssm_check(x, dt, a, b, c, torch.zeros(1, 2, 64, 64,
                                              dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        ssm_check(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, b,
                  c, None)
    with pytest.raises(ValueError, match="dt"):
        ssm_check(x, dt[:, :4], a, b, c, None)
    (r, k, v, w, u), _ = wkv_torch(wkv_inputs(10, 1, 8, 2, 64),
                                   torch.bfloat16)
    wkv_check(r, k, v, w, u, None)
    with pytest.raises(ValueError, match="head dim"):
        wkv_check(*(t[..., :32].contiguous() for t in (r, k, v, w)),
                  u[:, :32].contiguous(), None)
    with pytest.raises(ValueError, match="dtypes"):
        wkv_check(r, k, v, w.float(), u, None)
    with pytest.raises(ValueError, match="u: want float32"):
        wkv_check(r, k, v, w, u.bfloat16(), None)
    with pytest.raises(ValueError, match="state"):
        wkv_check(r, k, v, w, u, torch.zeros(1, 2, 64, 64,
                                             dtype=torch.bfloat16))
    odd = torch.empty(k.numel() + 1, dtype=k.dtype)[1:].view(k.shape)
    with pytest.raises(ValueError, match="aligned"):
        wkv_check(r, odd, v, w, u, None)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    return torch.device("cuda")


CARD_SSM = dict(SSM_CASES, **{
    "zamba2-prefill": (2, 32, 64, 64, 64, False),
    "ragged-chunks": (1, 2 * CHUNK + 3, 3, 64, 32, True),
    "exact-chunks": (2, 2 * CHUNK, 2, 64, 64, False),
    # the edges of the chunks and of the double-buffered loads
    "chunk-minus-1": (1, CHUNK - 1, 3, 64, 64, True),
    "chunk-plus-1": (2, CHUNK + 1, 2, 64, 64, False),
    "one-step-64": (2, 1, 4, 64, 64, True),
    "three-chunks-plus-1": (1, 3 * CHUNK + 1, 2, 64, 64, True),
    # Mamba2's own (N, P): every STATE_SHAPES entry has a case
    "mamba2-state": (1, 2 * CHUNK + 9, 2, 64, 128, True),
})
assert {(v[4], v[3]) for v in CARD_SSM.values()} >= set(STATE_SHAPES)
CARD_WKV = {k: v for k, v in WKV_CASES.items() if v[3] == 64}
CARD_WKV.update({
    "rwkv6-prefill": (2, 32, 64, 64, False),
    "rwkv6-decode": (2, 1, 64, 64, True),
    "ragged-chunks": (1, 77, 3, 64, True),
    # the edges of the kernel's chunks and of its unrolled step loop
    "chunk-minus-1": (1, WKV_CHUNK - 1, 3, 64, True),
    "chunk": (2, WKV_CHUNK, 2, 64, True),
    "chunk-plus-1": (1, WKV_CHUNK + 1, 2, 64, False),
    "two-chunks-plus-1": (1, 2 * WKV_CHUNK + 1, 2, 64, True),
    "one-step-no-state": (2, 1, 4, 64, False),
})
CARD_TOL = {torch.float32: CHUNKED_TOL, torch.bfloat16: BF16_TOL}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CARD_SSM))
def test_ssm_kernel_matches_plain_on_card(case, dtype, cuda_device):
    args, h0 = ssm_torch(ssm_inputs(11, *CARD_SSM[case]), dtype,
                         cuda_device)
    before = ssm_scan_cuda.launches
    y, h = ops.ssm_scan(*args, h0=h0)
    torch.cuda.synchronize()
    assert ssm_scan_cuda.launches == before + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    ye, he = ssm_scan_plain(*args, h0=h0)
    close(as_np(y), as_np(ye), CARD_TOL[dtype])
    close(as_np(h), as_np(he), CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, CHUNK - 1, 2 * CHUNK + 5])
def test_ssm_kernel_strong_decay_on_card(s, dtype, cuda_device):
    """a = -16 with large dt (exp(s) underflows inside a chunk) and a
    large h0: finite, and within the card's tolerance."""
    args, h0 = ssm_torch(ssm_inputs(17, 2, s, 4, 64, 64, True, True), dtype,
                         cuda_device)
    y, h = ssm_scan_cuda(*args, h0=h0)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    ye, he = ssm_scan_plain(*args, h0=h0)
    close(as_np(y), as_np(ye), CARD_TOL[dtype])
    close(as_np(h), as_np(he), CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CARD_WKV))
def test_wkv6_kernel_matches_plain_on_card(case, dtype, cuda_device):
    args, st = wkv_torch(wkv_inputs(12, *CARD_WKV[case]), dtype,
                         cuda_device)
    before = wkv6_cuda.launches
    y, s = ops.wkv6(*args, state=st)
    torch.cuda.synchronize()
    assert wkv6_cuda.launches == before + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    ye, se = wkv6_plain(*args, state=st)
    close(as_np(y), as_np(ye), CARD_TOL[dtype])
    close(as_np(s), as_np(se), CARD_TOL[dtype])


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    (x, dt, a, b, c), _ = ssm_torch(ssm_inputs(13, 1, 8, 2, 64, 64),
                                    torch.float32, cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        ssm_scan_cuda(x.half(), dt, a, b.half(), c.half())
    with pytest.raises(ValueError, match=r"\(N, P\)"):
        ssm_scan_cuda(x, dt, a, b[..., :8].contiguous(),
                      c[..., :8].contiguous())
    with pytest.raises(ValueError, match="one device"):
        ssm_scan_cuda(x, dt.cpu(), a, b, c)
    (r, k, v, w, u), _ = wkv_torch(wkv_inputs(13, 1, 8, 2, 64),
                                   torch.float32, cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        wkv6_cuda(r.double(), k.double(), v.double(), w.double(), u)
    with pytest.raises(ValueError, match="head dim"):
        wkv6_cuda(*(t[..., :32].contiguous() for t in (r, k, v, w)),
                  u[:, :32].contiguous())
    with pytest.raises(ValueError, match="one device"):
        wkv6_cuda(r, k, v, w, u.cpu())
