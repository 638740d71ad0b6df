"""Kernel B1 of the PyTorch port: the fused evict-and-place step.

The plain version ``evict_place_plain``, the port's sort composite
``"lax"`` and the registered ``"fused"`` backend (on CPU tensors) must
equal the reference's ``_evict_place_lax`` and its Pallas kernel in
interpret mode, bitwise, on tie-heavy quantized batches.  The CUDA
kernel itself is held against the plain version on the card (marker
``cuda``).  The reference is imported inside a fixture, so the file
also collects where JAX is absent (the GPU host), for the ``cuda`` tests.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.pool import _evict_place_lax as torch_lax
from repro_torch.core.pool import get_step_backend
from repro_torch.kernels.pool_step import (MAX_POOLS, MAX_SLOTS,
                                           evict_place_cuda,
                                           evict_place_plain,
                                           fused_evict_place,
                                           pack_keys_plain)

OUTPUTS = ("evict", "freed", "ins", "avail", "empty")
DTYPES = (torch.bool, torch.float32, torch.int32, torch.float32, torch.bool)


def random_batch(rng, p=8, s=24, busy_rows=0, nonpos_rows=0, full=False):
    """Mirrors ``tests/test_pool_kernel.py::_random_batch``: priorities
    in {0..3} (heavy ties), distinct seqs, whole-MB sizes; the first
    ``busy_rows`` rows have no idle slot and the next ``nonpos_rows``
    rows a deficit <= 0.  ``full`` fills every slot, so a row that
    evicts nothing has no empty slot."""
    pri = rng.integers(0, 4, (p, s)).astype(np.float32)
    seq = rng.permutation(np.arange(1.0, p * s + 1, dtype=np.float32)
                          ).reshape(p, s)
    size = rng.integers(1, 64, (p, s)).astype(np.float32)
    valid = (rng.random((p, s)) < 0.8) | full
    idle = valid & (rng.random((p, s)) < 0.7)
    idle[:busy_rows] = False
    pri = np.where(idle, pri, np.inf).astype(np.float32)
    deficit = rng.integers(-40, 400, (p,)).astype(np.float32)
    deficit[busy_rows:busy_rows + nonpos_rows] = -rng.integers(
        0, 40, nonpos_rows).astype(np.float32)
    return pri, seq, size, idle, valid, deficit


CASES = {
    "ties-0": dict(seed=0),
    "ties-1": dict(seed=1),
    "ties-2": dict(seed=2),
    "ties-3": dict(seed=3),
    "ties-4": dict(seed=4),
    "busy-and-nonpos": dict(seed=5, busy_rows=2, nonpos_rows=3),
    "ragged-37": dict(seed=6, p=5, s=37, busy_rows=1, nonpos_rows=1),
    "one-slot": dict(seed=7, p=3, s=1),
    "wide-300": dict(seed=8, p=4, s=300),
    "full-pools": dict(seed=9, p=6, s=16, nonpos_rows=3, full=True),
}


def make_case(name):
    kw = dict(CASES[name])
    return random_batch(np.random.default_rng(kw.pop("seed")), **kw)


def to_torch(args, device):
    return tuple(torch.tensor(a, device=device) for a in args)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(ref, got, what):
    """Bitwise on every output; the port's outputs keep the contract's
    dtypes."""
    for name, dt, r, g in zip(OUTPUTS, DTYPES, ref, got):
        if isinstance(g, torch.Tensor):
            assert g.dtype == dt, (what, name, g.dtype)
        assert np.array_equal(_np(r), _np(g)), (what, name)


@pytest.fixture(scope="module")
def jax_backends():
    """The reference's two backends (argsort composite, Pallas kernel in
    interpret mode), as the reference's own tests run them on CPU."""
    pool_jax = pytest.importorskip("repro.core.pool_jax")
    pallas = pytest.importorskip("repro.kernels.pool_step")
    import jax.numpy as jnp

    def run(args):
        jargs = tuple(jnp.asarray(a) for a in args)
        return (pool_jax._evict_place_lax(*jargs),
                pallas.fused_evict_place_impl(*jargs, interpret=True))
    return run


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_and_lax_match_both_reference_backends(case, jax_backends):
    """Bitwise, all five outputs: plain == port lax == reference lax ==
    reference Pallas kernel (interpret)."""
    args = make_case(case)
    ref_lax, ref_pallas = jax_backends(args)
    assert_same(ref_lax, ref_pallas, "reference lax vs pallas")
    targs = to_torch(args, "cpu")
    assert_same(ref_lax, evict_place_plain(*targs), "plain")
    assert_same(ref_lax, torch_lax(*targs), "lax")
    assert_same(ref_lax, fused_evict_place(*targs), "fused backend (cpu)")


def test_fused_backend_on_cpu_is_the_plain_version():
    assert get_step_backend("fused") is fused_evict_place
    targs = to_torch(make_case("ties-0"), "cpu")
    before = evict_place_cuda.launches
    fused_evict_place(*targs)
    assert evict_place_cuda.launches == before   # no kernel on a CPU tensor


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back: a CPU tensor raises."""
    targs = to_torch(make_case("ties-0"), "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        evict_place_cuda(*targs)


FLOATS = st.floats(width=32, allow_nan=False)
PRIORITIES = st.one_of(st.sampled_from([-0.0, 0.0, float("inf"), 1.0]),
                       FLOATS)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(PRIORITIES, FLOATS), min_size=1, max_size=24))
def test_packed_key_order_is_the_lex_float_order(pairs):
    """The kernel's packed key (mirrored by ``pack_keys_plain``) orders
    any non-NaN (pri, seq) pairs as the float compare's lex order does,
    ``-0.0`` equal to ``+0.0`` and infinities included: ``key_j < key_i``
    iff ``(pri_j, seq_j) <lex (pri_i, seq_i)``."""
    pri = torch.tensor([p for p, _ in pairs], dtype=torch.float32)
    seq = torch.tensor([q for _, q in pairs], dtype=torch.float32)
    key = pack_keys_plain(pri, seq)
    pi, pj = pri[:, None], pri[None, :]
    si, sj = seq[:, None], seq[None, :]
    lex_less = (pj < pi) | ((pj == pi) & (sj < si))
    assert torch.equal(key[None, :] < key[:, None], lex_less)
    assert torch.equal(key[None, :] == key[:, None], (pj == pi) & (sj == si))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, cuda_device):
    args = to_torch(make_case(case), cuda_device)
    before = evict_place_cuda.launches
    got = evict_place_cuda(*args)
    torch.cuda.synchronize()
    assert evict_place_cuda.launches == before + 1
    assert_same(tuple(t.cpu() for t in evict_place_plain(*args)), got,
                "kernel vs plain")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 256), (2, 1024), (3, 1000),
                                   (1, MAX_SLOTS)])
def test_kernel_matches_plain_at_path_shapes(shape, cuda_device):
    p, s = shape
    args = to_torch(random_batch(np.random.default_rng(p * s), p=p, s=s,
                                 busy_rows=min(1, p - 1)), cuda_device)
    got = evict_place_cuda(*args)
    torch.cuda.synchronize()
    assert_same(tuple(t.cpu() for t in evict_place_plain(*args)), got,
                f"kernel vs plain {shape}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(80, 1024), (192, 256)])
def test_kernel_matches_plain_at_sweep_shapes(shape, cuda_device):
    """A sweep group's rows, lane-major ``[L * 2N, S]``: the edge grid's
    40 static lanes of one node and the routing grid's six het16 lanes,
    one launch for every row."""
    p, s = shape
    args = to_torch(signed_zero_batch(np.random.default_rng(p + s), p, s),
                    cuda_device)
    before = evict_place_cuda.launches
    got = evict_place_cuda(*args)
    torch.cuda.synchronize()
    assert evict_place_cuda.launches == before + 1
    assert_same(tuple(t.cpu() for t in evict_place_plain(*args)), got,
                f"kernel vs plain {shape}")


@pytest.mark.cuda
def test_kernel_wrapper_refuses_rows_past_the_grid(cuda_device):
    """More rows than the launch's grid holds raise before any launch."""
    tall = to_torch(random_batch(np.random.default_rng(0), p=MAX_POOLS + 1,
                                 s=2), cuda_device)
    before = evict_place_cuda.launches
    with pytest.raises(ValueError, match="pools its"):
        evict_place_cuda(*tall)
    assert evict_place_cuda.launches == before


@pytest.mark.cuda
def test_kernel_wrapper_checks(cuda_device):
    args = to_torch(make_case("ties-0"), cuda_device)
    with pytest.raises(ValueError, match="deficit"):
        evict_place_cuda(*args[:5], args[5].double())
    with pytest.raises(ValueError, match="contiguous"):
        evict_place_cuda(args[0].t().contiguous().t(), *args[1:])
    wide = to_torch(random_batch(np.random.default_rng(0), p=1,
                                 s=MAX_SLOTS + 1), cuda_device)
    with pytest.raises(ValueError, match="slots exceed"):
        evict_place_cuda(*wide)


def signed_zero_batch(rng, p, s):
    """Tie-heavy quantized rows whose zero priorities are ``-0.0`` or
    ``+0.0`` at random, ``+inf`` on busy slots; with more than two rows,
    row 0 is all busy and row 1 has a deficit <= 0."""
    pri, seq, size, idle, valid, deficit = random_batch(
        rng, p=p, s=s, busy_rows=min(1, p - 1),
        nonpos_rows=max(0, min(1, p - 2)))
    pri = np.where((pri == 0) & (rng.random((p, s)) < 0.5), -0.0, pri)
    deficit = np.where(deficit > 0, rng.integers(1, 20 * s + 2, p),
                       deficit).astype(np.float32)
    return pri.astype(np.float32), seq, size, idle, valid, deficit


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 65])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 256, 1000,
                               1024, MAX_SLOTS])
def test_kernel_matches_plain_at_every_cluster_size(p, s, cuda_device):
    """Slot counts on both sides of the kernel's cluster sizes (a block
    for every 64 slots, up to 16) and of its 4-slot vector loads: bitwise
    against the plain version, one launch a call."""
    rng = np.random.default_rng(1000 * p + s)
    batch = signed_zero_batch(rng, p, s)
    assert (np.signbit(batch[0]) & (batch[0] == 0)).any() or s < 8
    args = to_torch(batch, cuda_device)
    before = evict_place_cuda.launches
    got = evict_place_cuda(*args)
    torch.cuda.synchronize()
    assert evict_place_cuda.launches == before + 1
    assert_same(tuple(t.cpu() for t in evict_place_plain(*args)), got,
                f"kernel vs plain [{p}, {s}]")
