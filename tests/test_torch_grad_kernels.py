"""The autograd Functions of kernels B3, B4 and B5 and their explicit
backward passes, on the CPU.

On the card ``kernels.ops`` runs each kernel inside a
``torch.autograd.Function`` whose backward is the kernel module's plain
torch gradient (``flash_attention_bwd``, ``ssm_scan_bwd``,
``wkv6_bwd``).  Here each Function is built around the kernel's plain
version in the kernel's place, so its backward is held against autograd
of that plain version, on the same inputs (from a numpy seed) and the
same upstream grads, for every output (the scans' final states too) and
every input (the initial state too).  Tolerance: 1e-5 of each grad's
largest magnitude, in f32: both sides compute in f32 and differ in the
order of their sums (the scan's chunked matrix form against the
sequential recurrence); a lost mask, a GQA head summed into the wrong kv
head or a state grad that is not carried lies far outside it.  bf16
inputs (one case each) are held to 2e-2, the kernels' own bf16 bound:
autograd of the plain attention rounds dP to bf16, the Function's
backward runs in f32.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_plain)
from repro_torch.kernels.ssm_scan import ssm_scan_bwd, ssm_scan_plain
from repro_torch.kernels.wkv6 import wkv6_plain

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def rand(rng, shape, dtype=torch.float32, scale=1.0, shift=0.0):
    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(dtype).requires_grad_()


def check(got, want, dtype, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        err = float((g.float() - w.float()).abs().max())
        bound = TOL[dtype] * float(w.float().abs().max())
        assert err <= bound, f"{what}: grad {i} off by {err} > {bound}"


#: (B, Sq, Skv, H, KV, D, causal, window, q_offset)
ATTN = {
    "causal-gqa": (2, 13, 13, 4, 2, 16, True, None, 0),
    "window-offset": (2, 9, 20, 6, 2, 8, True, 5, 11),
    "non-causal-cross": (1, 7, 30, 4, 4, 8, False, None, 0),
    "group-of-3-window": (1, 17, 17, 6, 2, 8, True, 4, 0),
}


@pytest.mark.parametrize("name,dtype", [
    *((n, torch.float32) for n in sorted(ATTN)),
    ("causal-gqa", torch.bfloat16)])
def test_flash_attention_function(name, dtype):
    b, sq, skv, h, kv, d, causal, window, q_offset = ATTN[name]
    rng = np.random.default_rng(len(name))
    q = rand(rng, (b, sq, h, d), dtype)
    k = rand(rng, (b, skv, kv, d), dtype)
    v = rand(rng, (b, skv, kv, d), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    fn = ops.flash_attention_function(flash_attention_plain)
    out = fn.apply(q, k, v, causal, window, None, q_offset)
    want = flash_attention_plain(q, k, v, **kw)
    assert torch.equal(out, want)
    do = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(dtype)
    got = torch.autograd.grad(out, (q, k, v), do)
    ref = torch.autograd.grad(want, (q, k, v), do)
    check(got, ref, dtype, name)


@pytest.mark.parametrize("chunk", [4, 16])
def test_flash_attention_bwd_query_chunks(chunk):
    """The backward's query chunks (here smaller than Sq) sum into one
    dk and dv."""
    rng = np.random.default_rng(1)
    q, k, v = (rand(rng, (2, 11, 4, 8)) for _ in range(3))
    want = flash_attention_plain(q, k, v, window=6)
    do = torch.randn(want.shape, generator=torch.Generator().manual_seed(0))
    ref = torch.autograd.grad(want, (q, k, v), do)
    got = flash_attention_bwd(q.detach(), k.detach(), v.detach(), do,
                              window=6, chunk=chunk)
    check(got, ref, torch.float32, f"chunk {chunk}")


#: (B, S, H, P, N, with h0, the backward's chunk)
SSM = {
    "one-chunk": (2, 20, 3, 4, 5, False, 64),
    "ragged-chunks-h0": (2, 37, 3, 4, 5, True, 8),
    "whole-chunks-h0": (1, 32, 2, 8, 4, True, 16),
    "short-h0": (2, 5, 2, 3, 4, True, 8),
    "no-h0-many-chunks": (1, 70, 2, 4, 4, False, 16),
}


def ssm_inputs(rng, bsz, s, hh, p, n, with_h0, dtype=torch.float32):
    x = rand(rng, (bsz, s, hh, p), dtype)
    dt = torch.from_numpy(rng.uniform(0.01, 0.6, (bsz, s, hh)).astype(
        np.float32)).requires_grad_()
    a = torch.from_numpy(-rng.uniform(0.5, 3.0, hh).astype(
        np.float32)).requires_grad_()
    b = rand(rng, (bsz, s, hh, n), dtype)
    c = rand(rng, (bsz, s, hh, n), dtype)
    h0 = rand(rng, (bsz, hh, n, p)) if with_h0 else None
    return x, dt, a, b, c, h0


@pytest.mark.parametrize("name", sorted(SSM))
def test_ssm_scan_function(name, monkeypatch):
    bsz, s, hh, p, n, with_h0, chunk = SSM[name]
    rng = np.random.default_rng(len(name))
    x, dt, a, b, c, h0 = ssm_inputs(rng, bsz, s, hh, p, n, with_h0)
    monkeypatch.setattr(ops, "ssm_scan_bwd",
                        lambda *t: ssm_scan_bwd(*t, chunk=chunk))
    fn = ops.ssm_scan_function(ssm_scan_plain)
    y, hf = fn.apply(x, dt, a, b, c, h0)
    wy, wh = ssm_scan_plain(x, dt, a, b, c, h0=h0)
    assert torch.equal(y, wy) and torch.equal(hf, wh)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal(hf.shape).astype(np.float32))
    ins = [t for t in (x, dt, a, b, c, h0) if t is not None]
    got = torch.autograd.grad((y, hf), ins, (dy, dh))
    ref = torch.autograd.grad((wy, wh), ins, (dy, dh))
    check(got, ref, torch.float32, name)


def test_ssm_scan_bwd_bf16_and_y_only():
    """bf16 x, b and c (grads in bf16, dt/a in f32), and only y's grad
    (the final state unused, as in training)."""
    rng = np.random.default_rng(3)
    x, dt, a, b, c, _ = ssm_inputs(rng, 2, 40, 2, 4, 4, False,
                                   torch.bfloat16)
    fn = ops.ssm_scan_function(ssm_scan_plain)
    dy = torch.from_numpy(rng.standard_normal((2, 40, 2, 4)).astype(
        np.float32)).to(torch.bfloat16)
    got = torch.autograd.grad(fn.apply(x, dt, a, b, c, None)[0],
                              (x, dt, a, b, c), dy)
    ref = torch.autograd.grad(ssm_scan_plain(x, dt, a, b, c)[0],
                              (x, dt, a, b, c), dy)
    check(got, ref, torch.bfloat16, "bf16")


#: (B, S, H, D, with an initial state)
WKV = {"no-state": (2, 11, 3, 8, False), "state": (2, 9, 2, 8, True),
       "one-step-state": (1, 1, 2, 8, True)}


def wkv_inputs(rng, bsz, s, h, d, with_state, dtype=torch.float32):
    r, k, v = (rand(rng, (bsz, s, h, d), dtype) for _ in range(3))
    w = rand(rng, (bsz, s, h, d), dtype, scale=1.0, shift=-1.0)
    u = rand(rng, (h, d))
    st = rand(rng, (bsz, h, d, d)) if with_state else None
    return r, k, v, w, u, st


@pytest.mark.parametrize("name", sorted(WKV))
def test_wkv6_function(name):
    rng = np.random.default_rng(len(name))
    ins = wkv_inputs(rng, *WKV[name])
    fn = ops.wkv6_function(wkv6_plain)
    y, sf = fn.apply(*ins)
    wy, ws = wkv6_plain(*ins[:5], state=ins[5])
    assert torch.equal(y, wy) and torch.equal(sf, ws)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    ds = torch.from_numpy(rng.standard_normal(sf.shape).astype(np.float32))
    diff = [t for t in ins if t is not None]
    got = torch.autograd.grad((y, sf), diff, (dy, ds))
    ref = torch.autograd.grad((wy, ws), diff, (dy, ds))
    check(got, ref, torch.float32, name)


def test_wkv6_bwd_bf16():
    rng = np.random.default_rng(4)
    r, k, v, w, u, _ = wkv_inputs(rng, 2, 12, 2, 8, False, torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((2, 12, 2, 8)).astype(
        np.float32)).to(torch.bfloat16)
    got = torch.autograd.grad(
        ops.wkv6_function(wkv6_plain).apply(r, k, v, w, u, None)[0],
        (r, k, v, w, u), dy)
    ref = torch.autograd.grad(wkv6_plain(r, k, v, w, u)[0],
                              (r, k, v, w, u), dy)
    check(got, ref, torch.bfloat16, "bf16")


@pytest.fixture
def fake_card(monkeypatch):
    """``ops`` routed as on the card, with a counting stand-in (the plain
    version) for each kernel and its Function built around the stand-in;
    returns the calls a kernel."""
    calls = {}

    def stand_in(name, plain):
        def kernel(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return plain(*args, **kw)
        return kernel
    kernels = {"flash_attention": stand_in("flash_attention",
                                           flash_attention_plain),
               "ssm_scan": stand_in("ssm_scan", ssm_scan_plain),
               "wkv6": stand_in("wkv6", wkv6_plain)}
    for name, k in kernels.items():
        monkeypatch.setattr(ops, f"{name}_cuda", k)
    monkeypatch.setattr(ops, "FlashAttention", ops.flash_attention_function(
        kernels["flash_attention"]))
    monkeypatch.setattr(ops, "SSMScan",
                        ops.ssm_scan_function(kernels["ssm_scan"]))
    monkeypatch.setattr(ops, "WKV6", ops.wkv6_function(kernels["wkv6"]))
    monkeypatch.setattr(ops, "_route", lambda what, t, kernel, plain: kernel)
    return calls


def test_function_entered_only_when_a_grad_is_needed(fake_card):
    """Serving's calls (no input requiring grad, or grad mode off) reach
    the kernel directly; a training call goes through the Function, whose
    backward runs no kernel."""
    rng = np.random.default_rng(5)
    q, k, v = (rand(rng, (1, 6, 2, 8)).detach() for _ in range(3))
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None and fake_card == {"flash_attention": 1}
    q.requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    out = ops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    assert fake_card == {"flash_attention": 3} and q.grad is not None

    x, dt, a, b, c, _ = (t.detach() if t is not None else t for t in
                         ssm_inputs(rng, 1, 5, 2, 4, 4, False))
    y, _ = ops.ssm_scan(x, dt, a, b, c)
    assert y.grad_fn is None
    a.requires_grad_()                  # a grad for a alone enters it
    y, _ = ops.ssm_scan(x, dt, a, b, c)
    assert type(y.grad_fn).__name__ == "SSMScanBackward"
    y.sum().backward()
    assert a.grad.shape == a.shape

    r, kk, vv, w, u, st = (t.detach() for t in
                           wkv_inputs(rng, 1, 3, 2, 8, True))
    assert ops.wkv6(r, kk, vv, w, u, state=st)[0].grad_fn is None
    st.requires_grad_()                 # so does the initial state's
    y, _ = ops.wkv6(r, kk, vv, w, u, state=st)
    assert type(y.grad_fn).__name__ == "WKV6Backward"
    y.sum().backward()
    assert st.grad.shape == st.shape
    assert fake_card == {"flash_attention": 3, "ssm_scan": 2, "wkv6": 2}


def test_cpu_tensors_run_the_plain_versions_under_autograd():
    """On the CPU no Function is entered: autograd differentiates the
    plain versions themselves."""
    rng = np.random.default_rng(6)
    q, k, v = (rand(rng, (1, 6, 2, 8)) for _ in range(3))
    out = ops.flash_attention(q, k, v)
    assert "FlashAttention" not in type(out.grad_fn).__name__
    assert ops.needs_grad(q, None) and not ops.needs_grad(q.detach(), None)


# ---------------------------------------------------------------------------
# on the card: the real kernels inside their Functions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    return torch.device("cuda")


def card_check(entry, kernel, plain, inputs, dtype, n_out):
    """``entry`` (an ``ops`` entry point) on inputs that require grad
    launches the kernel once, inside its Function, and its backward
    launches none; grads against autograd of ``plain``."""
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    before = kernel.launches
    out = entry(*ins)
    out = out if isinstance(out, tuple) else (out,)
    assert kernel.launches == before + 1
    assert "Backward" in type(out[0].grad_fn).__name__
    want = plain(*ins)
    want = want if isinstance(want, tuple) else (want,)
    gen = torch.Generator(device=out[0].device).manual_seed(0)
    ups = [torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
           for o in out[:n_out]]
    got = torch.autograd.grad(out[:n_out], ins, ups)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    check(got, torch.autograd.grad(want[:n_out], ins, ups),
          torch.float32 if dtype == torch.float32 else torch.bfloat16,
          entry.__name__)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_on_card(dtype, cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda
    tol = TOL[torch.float32]
    TOL[torch.float32] = 1e-4       # the card sums in another order
    try:
        rng = np.random.default_rng(7)
        qkv = [rand(rng, sh, dtype).to(cuda_device) for sh in
               ((2, 40, 8, 64), (2, 40, 2, 64), (2, 40, 2, 64))]
        card_check(ops.flash_attention, flash_attention_cuda,
                   flash_attention_plain, qkv, dtype, 1)
        x, dt, a, b, c, _ = ssm_inputs(rng, 2, 70, 2, 32, 16, False, dtype)
        card_check(ops.ssm_scan, ssm_scan_cuda, ssm_scan_plain,
                   [t.to(cuda_device) for t in (x, dt, a, b, c)], dtype, 2)
        r, k, v, w, u, _ = wkv_inputs(rng, 2, 40, 2, 64, False, dtype)
        card_check(ops.wkv6, wkv6_cuda, wkv6_plain,
                   [t.to(cuda_device) for t in (r, k, v, w, u)], dtype, 2)
    finally:
        TOL[torch.float32] = tol
