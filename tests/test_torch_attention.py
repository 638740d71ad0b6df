"""Kernels B2 (decode attention) and B3 (flash attention) of the PyTorch
port.

On the CPU the port's plain versions are held against the reference's
oracles (``repro.kernels.ref``) and its Pallas kernels in interpret mode,
as ``tests/test_kernels.py`` runs them, at a few of its shapes (MQA, GQA,
zamba2's MHA with D = 64 and G = 1, a group of 24 heads, a window,
ragged lengths, holes in the cache) and at kimi-k2's head dim of 112
with its group of 8.  The tolerance is the reference's
own ``TOL``: 2e-5 in f32, 2e-2 in bf16 (absolute and relative).  On the
card (marker ``cuda``) each CUDA kernel is held against its plain
version at the same tolerances: in bf16 that is the tensor-core kernel
(``wgmma`` for B3, ``mma.sync`` for B2), in f32 the CUDA-core one.  The
reference is imported inside fixtures, so the file also collects where
JAX is absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_plain)
from repro_torch.kernels.decode_attention import \
    check_inputs as decode_check
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.flash_attention import check_inputs as flash_check

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def flash_inputs(seed, b, sq, skv, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, skv, kv, d), np.float32),
            rng.standard_normal((b, skv, kv, d), np.float32))


def decode_inputs(seed, b, s, h, kv, d, cur=None):
    """Cache with holes (every 5th slot empty), as the reference's sweep
    has them; ``cur`` defaults to the middle of the cache."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), np.float32)
    kc = rng.standard_normal((b, s, kv, d), np.float32)
    vc = rng.standard_normal((b, s, kv, d), np.float32)
    sp = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    sp[sp % 5 == 2] = -1
    cur = np.full((b,), s // 2 if cur is None else cur, np.int32)
    return q, kc, vc, sp, cur


def to_torch(arrays, dtype, device="cpu"):
    """Float arrays in ``dtype`` (rounded from f32 as JAX rounds), int
    arrays as they are."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        out.append(t.to(TORCH_DTYPE[dtype]) if t.is_floating_point() else t)
    return out


def close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def as_np(t: torch.Tensor):
    return t.detach().float().cpu().numpy()


@pytest.fixture(scope="module")
def ref():
    """The reference's oracles and Pallas kernels (interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as oracle
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.flash_attention import flash_attention_pallas

    def j(arrays, dtype):
        return [jnp.asarray(a, getattr(jnp, dtype))
                if a.dtype == np.float32 else jnp.asarray(a)
                for a in arrays]
    return dict(oracle=oracle, flash_pallas=flash_attention_pallas,
                decode_pallas=decode_attention_pallas, j=j)


FLASH_CASES = {   # name: (b, sq, skv, h, kv, d, causal, window, q_offset)
    "mqa": (1, 128, 128, 4, 1, 64, True, None, 0),
    "gqa-window": (2, 256, 256, 8, 2, 64, True, 96, 0),
    "wide-noncausal": (1, 128, 128, 4, 4, 128, False, None, 0),
    "ragged-offset": (2, 37, 70, 6, 2, 64, True, 40, 33),
    "zamba2-mha": (2, 96, 96, 4, 4, 64, True, None, 0),
    "gqa24-ragged": (1, 100, 100, 24, 1, 128, True, None, 0),
    # kimi-k2-1t-a32b: D = 112, G = 8
    "kimi-d112": (1, 128, 128, 16, 2, 112, True, None, 0),
    "kimi-d112-ragged": (2, 37, 90, 8, 1, 112, True, 30, 50),
    # qwen2-vl-7b's odd GQA group of 7, and whisper's cross-attention: a
    # few decoder queries against more encoder frames, no mask
    "group7": (1, 40, 40, 14, 2, 128, True, None, 0),
    "cross-noncausal": (2, 9, 150, 4, 4, 64, False, None, 0),
}
DECODE_CASES = {  # name: (b, s, h, kv, d, window)
    "gqa": (2, 1024, 8, 2, 64, None),
    "mqa-ring": (2, 1024, 8, 1, 128, 600),
    "ragged-window": (3, 300, 12, 2, 64, 100),
    "zamba2-mha": (2, 512, 4, 4, 64, None),
    "gqa24-ragged": (1, 200, 24, 1, 128, None),
    "kimi-d112": (2, 512, 16, 2, 112, None),
    "kimi-d112-window": (1, 300, 8, 1, 112, 100),
    "group7": (2, 300, 14, 2, 128, None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_reference_oracle(case, dtype, ref):
    b, sq, skv, h, kv, d, causal, window, q_offset = FLASH_CASES[case]
    arrays = flash_inputs(1, b, sq, skv, h, kv, d)
    want = ref["oracle"].flash_attention(*ref["j"](arrays, dtype),
                                         causal=causal, window=window,
                                         q_offset=q_offset)
    got = flash_attention_plain(*to_torch(arrays, dtype), causal=causal,
                                window=window, q_offset=q_offset)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (b, sq, h, d)
    close(as_np(got), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["mqa", "gqa-window", "zamba2-mha",
                                  "gqa24-ragged", "kimi-d112"])
def test_flash_plain_matches_pallas_interpret(case, dtype, ref):
    b, sq, skv, h, kv, d, causal, window, q_offset = FLASH_CASES[case]
    arrays = flash_inputs(2, b, sq, skv, h, kv, d)
    want = ref["flash_pallas"](*ref["j"](arrays, dtype), causal=causal,
                               window=window, interpret=True)
    got = ops.flash_attention(*to_torch(arrays, dtype), causal=causal,
                              window=window)
    close(as_np(got), want, dtype)


def test_flash_plain_query_chunks_agree():
    """The query-chunked path equals one block over all queries."""
    arrays = to_torch(flash_inputs(3, 1, 300, 300, 4, 2, 64), "float32")
    one = flash_attention_plain(*arrays, window=50)
    chunked = flash_attention_plain(*arrays, window=50, chunk=64)
    close(as_np(chunked), as_np(one), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_reference_oracle(case, dtype, ref):
    b, s, h, kv, d, window = DECODE_CASES[case]
    arrays = decode_inputs(4, b, s, h, kv, d)
    want = ref["oracle"].decode_attention(*ref["j"](arrays, dtype),
                                          window=window)
    got = decode_attention_plain(*to_torch(arrays, dtype), window=window)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (b, h, d)
    close(as_np(got), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["gqa", "mqa-ring", "zamba2-mha",
                                  "gqa24-ragged", "kimi-d112"])
def test_decode_plain_matches_pallas_interpret(case, dtype, ref):
    b, s, h, kv, d, window = DECODE_CASES[case]
    arrays = decode_inputs(5, b, s, h, kv, d)
    want = ref["decode_pallas"](*ref["j"](arrays, dtype), window=window,
                                interpret=True, block_s=256)
    got = ops.decode_attention(*to_torch(arrays, dtype), window=window)
    close(as_np(got), want, dtype)


def test_decode_plain_row_with_no_visible_slot(ref):
    """A row that sees no slot gets the reference's uniform softmax (the
    mean of every V row), not zeros or NaN."""
    arrays = list(decode_inputs(6, 2, 256, 4, 2, 64))
    arrays[3][1] = -1                     # sequence 1: an empty cache
    want = ref["oracle"].decode_attention(*ref["j"](arrays, "float32"))
    got = decode_attention_plain(*to_torch(arrays, "float32"))
    close(as_np(got), want, "float32")
    assert np.isfinite(as_np(got)).all()


def test_cpu_tensors_take_the_plain_version_only():
    fa = to_torch(flash_inputs(7, 1, 16, 16, 2, 1, 64), "float32")
    da = to_torch(decode_inputs(7, 1, 64, 2, 1, 64), "float32")
    before = (flash_attention_cuda.launches, decode_attention_cuda.launches)
    ops.flash_attention(*fa)
    ops.decode_attention(*da)
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(*fa)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention_cuda(*da)
    with pytest.raises(ValueError, match="no attention"):
        ops.flash_attention(*(t.to("meta") for t in fa))


def test_kernel_input_checks():
    """What the wrappers refuse, checked before any launch."""
    q, k, v = to_torch(flash_inputs(8, 1, 16, 16, 2, 1, 64), "float32")
    flash_check(q, k, v, True, None, 0)
    with pytest.raises(ValueError, match="head dim"):
        flash_check(q[..., :32].contiguous(), k[..., :32].contiguous(),
                    v[..., :32].contiguous(), True, None, 0)
    with pytest.raises(ValueError, match="dtypes"):
        flash_check(q, k.double(), v, True, None, 0)
    with pytest.raises(ValueError, match="dtypes"):
        flash_check(q.half(), k.half(), v.half(), True, None, 0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_check(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                    True, None, 0)
    with pytest.raises(ValueError, match="sees no key"):
        flash_check(q, k, v, True, 4, 20)
    dq, dk, dv, sp, cur = to_torch(decode_inputs(8, 1, 64, 2, 1, 64),
                                   "bfloat16")
    decode_check(dq, dk, dv, sp, None)
    with pytest.raises(ValueError, match="slot_pos"):
        decode_check(dq, dk, dv, sp.long(), None)
    with pytest.raises(ValueError, match="dtypes"):
        decode_check(dq.float(), dk, dv, sp, None)
    with pytest.raises(ValueError, match="head dim"):
        decode_check(dq[..., :48].contiguous(), dk[..., :48].contiguous(),
                     dv[..., :48].contiguous(), sp, None)
    odd = torch.empty(dk.numel() + 1, dtype=dk.dtype)[1:].view(dk.shape)
    with pytest.raises(ValueError, match="aligned"):
        decode_check(dq, odd, dv, sp, None)


@pytest.mark.parametrize("d,takes", [(112, True), (96, False)])
def test_kernels_take_head_dim_112_only_beside_64_and_128(d, takes):
    """kimi-k2's D = 112 is built (zero-padded to 128 columns inside the
    bf16 flash kernel, a template instance elsewhere); other dims such as
    96 still raise before any launch."""
    q, k, v = to_torch(flash_inputs(12, 1, 16, 16, 8, 1, d), "bfloat16")
    dq, dk, dv, sp, _ = to_torch(decode_inputs(12, 1, 64, 8, 1, d),
                                 "bfloat16")
    if takes:
        flash_check(q, k, v, True, None, 0)
        decode_check(dq, dk, dv, sp, None)
        return
    with pytest.raises(ValueError, match="head dim"):
        flash_check(q, k, v, True, None, 0)
    with pytest.raises(ValueError, match="head dim"):
        decode_check(dq, dk, dv, sp, None)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    return torch.device("cuda")


CARD_FLASH = dict(FLASH_CASES, **{
    "path-starcoder2": (2, 32, 32, 24, 2, 128, True, 4096, 0),
    "path-glm4": (2, 32, 32, 32, 2, 128, True, None, 0),
    "ragged-long": (1, 333, 1000, 8, 2, 128, True, 200, 700),
    "one-row": (3, 1, 65, 4, 2, 64, True, None, 64),
    "path-zamba2": (2, 32, 32, 32, 32, 64, True, None, 0),
    # a partial last 128-row query tile and a partial kv tile
    "partial-200": (1, 200, 200, 8, 2, 128, True, None, 0),
    "partial-200-d64": (2, 200, 200, 4, 4, 64, False, None, 0),
    # positions 200..263 see keys 101..263: the band crosses the kv
    # tiles' edges at 128 and 256
    "offset-band-edge": (1, 64, 300, 4, 2, 128, True, 100, 200),
    # kimi-k2's attention (H = 64, KV = 8, D = 112): its serving prefill,
    # and a ragged one with a window and a query offset
    "kimi-d112-path": (2, 32, 32, 64, 8, 112, True, None, 0),
    "kimi-d112-offset": (1, 333, 1000, 64, 8, 112, True, 200, 700),
    # granite-moe-1b-a400m's prefill (H = 16 over KV = 8, D = 64) and
    # qwen2-vl-7b's (a group of 7, D = 128); whisper-medium's encoder
    # over 1,500 frames and its cross-attention at the prefill (Sq = 32)
    # and at each decode step (Sq = 1), all without the causal mask and
    # with a ragged last kv tile (1,500 = 11 x 128 + 92)
    "path-granite-moe": (2, 32, 32, 16, 8, 64, True, None, 0),
    "path-qwen2vl": (2, 32, 32, 28, 4, 128, True, None, 0),
    "whisper-enc": (2, 1500, 1500, 16, 16, 64, False, None, 0),
    "whisper-x32": (2, 32, 1500, 16, 16, 64, False, None, 0),
    "whisper-x1": (2, 1, 1500, 16, 16, 64, False, None, 0),
})
CARD_DECODE = dict(DECODE_CASES, **{
    "path-starcoder2": (2, 4096, 24, 2, 128, 4096),
    "path-glm4": (2, 4096, 32, 2, 128, None),
    "ragged-one-slot": (1, 1, 4, 4, 64, None),
    "mqa-48": (2, 777, 48, 1, 128, None),
    "serving-fill": (2, 4096, 24, 2, 128, 4096),
    "40-chunks": (1, 5000, 8, 2, 64, None),
    "path-zamba2": (2, 4096, 32, 32, 64, None),
    # a ring whose visible positions (the last 64, holes aside) sit at
    # slots 97..160: two chunks
    "ring-straddle": (2, 512, 16, 2, 128, 64),
    # kimi-k2's decode (H = 64, KV = 8, D = 112): the serving cache, and
    # the straddling ring with holes
    "kimi-d112-path": (2, 4096, 64, 8, 112, None),
    "kimi-d112-ring": (2, 512, 64, 8, 112, 64),
    # the decode caches of granite-moe, qwen2-vl (a group of 7) and
    # whisper's decoder (448 target positions, MHA)
    "path-granite-moe": (2, 4096, 16, 8, 64, None),
    "path-qwen2vl": (2, 4096, 28, 4, 128, None),
    "path-whisper": (2, 448, 16, 16, 64, None),
})
#: Cases whose cache is filled as served (slots 0..35), and rings whose
#: position p sits at slot p % S.
SERVING_FILL = ("serving-fill", "path-zamba2", "kimi-d112-path",
                "path-granite-moe", "path-qwen2vl", "path-whisper")
RINGS = ("ring-straddle", "kimi-d112-ring")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CARD_FLASH))
def test_flash_kernel_matches_plain_on_card(case, dtype, cuda_device):
    b, sq, skv, h, kv, d, causal, window, q_offset = CARD_FLASH[case]
    args = to_torch(flash_inputs(9, b, sq, skv, h, kv, d), dtype,
                    cuda_device)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(*args, causal=causal, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    want = flash_attention_plain(*args, causal=causal, window=window,
                                 q_offset=q_offset)
    close(as_np(got), as_np(want), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CARD_DECODE))
def test_decode_kernel_matches_plain_on_card(case, dtype, cuda_device):
    b, s, h, kv, d, window = CARD_DECODE[case]
    cur = 672 if case in RINGS else max(s - 3, 0)
    arrays = list(decode_inputs(10, b, s, h, kv, d, cur=cur))
    if case in SERVING_FILL:              # slots 0..35, as served
        arrays[3][:, 36:] = -1
    if case in RINGS:                     # position p at slot p % s
        pos = np.arange(cur - s + 1, cur + 1)
        arrays[3][:, pos % s] = np.where(pos % 5 == 2, -1, pos)
    if b > 1:
        arrays[3][-1] = -1                # last sequence: nothing visible
    args = to_torch(arrays, dtype, cuda_device)
    before = decode_attention_cuda.launches
    got = ops.decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    want = decode_attention_plain(*args, window=window)
    close(as_np(got), as_np(want), dtype)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v = to_torch(flash_inputs(11, 1, 16, 16, 2, 1, 64), "float32",
                       cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*(torch.cat([t, t[..., :32]], -1)
                               for t in (q, k, v)))      # D = 96
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q[..., :32].contiguous(),
                             k[..., :32].contiguous(),
                             v[..., :32].contiguous())
    with pytest.raises(ValueError, match="one device"):
        flash_attention_cuda(q, k.cpu(), v)
    dq, dk, dv, sp, cur = to_torch(decode_inputs(11, 1, 64, 2, 1, 64),
                                   "float32", cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        decode_attention_cuda(dq.double(), dk.double(), dv.double(), sp,
                              cur)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention_cuda(dq[..., :32].contiguous(),
                              dk[..., :32].contiguous(),
                              dv[..., :32].contiguous(), sp, cur)
