"""The port's model stacks against the JAX reference, on the CPU.

Reduced starcoder2-3b (LayerNorm, tanh-GELU MLP, QKV bias, a 64-token
sliding window) and glm4-9b (RMSNorm, gated SiLU), reduced zamba2-1.2b
(Mamba2 layers around one shared attention block; 2 layers, and 4 so
that the shared block runs at two positions with a cache each) and
reduced rwkv6-7b (attention-free), in f32, with the reference's weights
carried across by ``repro_torch.checkpoint``.  Inputs come from a numpy
seed.  Tolerance: 1e-5 absolute and relative in f32 — both sides compute
in f32 and differ only in summation order and in the last ulp of
``pow``/``exp``/``tanh``; the recurrences run the sequential oracle on
both sides (the port's plain scans); a tanh-vs-erf GELU mix-up (~1e-3), a
lost window or a state that is not carried lies far outside it.  The
reference is imported inside fixtures, so the file also collects where
JAX is absent.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.checkpoint import (load_reference_checkpoint,
                                    params_from_reference)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import (decode_step, forward_train, init_params,
                                prefill)
from repro_torch.models import attention as T_attn
from repro_torch.models import layers as T_layers
from repro_torch.models import rope as T_rope

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("starcoder2-3b", "glm4-9b")
#: name: (arch, layers) of the recurrent families' reduced variants.
RECURRENT = {"zamba2-1.2b": ("zamba2-1.2b", 2),
             "zamba2-4-layers": ("zamba2-1.2b", 4),
             "rwkv6-7b": ("rwkv6-7b", 2)}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.checkpoint as ckpt
    import repro.models as models
    from repro.models import attention, layers, rope
    return dict(jax=jax, jnp=jnp, models=models, attention=attention,
                layers=layers, rope=rope, ckpt=ckpt)


@pytest.fixture(scope="module")
def pair(ref):
    """Per arch: (reduced cfg, reference params, the port's params)."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(3))
        tp = params_from_reference(
            ref["jax"].tree_util.tree_map(np.asarray, rp), cfg, "cpu")
        out[arch] = (cfg, rp, tp)
    return out


@pytest.fixture(scope="module")
def rec(ref):
    """Per ``RECURRENT`` name: (reduced cfg, reference params, the port's
    params)."""
    out = {}
    for name, (arch, n_layers) in RECURRENT.items():
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  n_layers=n_layers)
        rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(4))
        tp = params_from_reference(
            ref["jax"].tree_util.tree_map(np.asarray, rp), cfg, "cpu")
        out[name] = (cfg, rp, tp)
    return out


def tt(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def batch(ref, tokens, pos0=0):
    """The same batch for both packages: tokens, positions, seq_positions."""
    b, s = tokens.shape
    pos = np.broadcast_to(np.arange(pos0, pos0 + s, dtype=np.int32),
                          (b, s)).copy()
    jb = {k: ref["jnp"].asarray(v) for k, v in
          (("tokens", tokens), ("positions", pos), ("seq_positions", pos))}
    tb = {k: tt(v) for k, v in
          (("tokens", tokens), ("positions", pos), ("seq_positions", pos))}
    return jb, tb


def layer0(rp, tp):
    """Layer 0's params on both sides (the reference's are stacked)."""
    import jax
    return jax.tree_util.tree_map(lambda a: a[0], rp["layers"]), \
        tp["layers"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_norm(arch, pair, ref):
    cfg, rp, tp = pair[arch]
    x = np.random.default_rng(0).standard_normal((2, 5, cfg.d_model),
                                                 np.float32) * 3 + 1
    rl, tl = layer0(rp, tp)
    close(T_layers.norm(tl["ln1"], tt(x), cfg.norm_eps),
          ref["layers"].norm(rl["ln1"], ref["jnp"].asarray(x), cfg.norm_eps))
    assert ("b" in tl["ln1"]) == (cfg.norm_type == "layernorm")


@pytest.mark.parametrize("arch", ARCHS)
def test_mlp(arch, pair, ref):
    cfg, rp, tp = pair[arch]
    x = np.random.default_rng(1).standard_normal((2, 5, cfg.d_model),
                                                 np.float32)
    rl, tl = layer0(rp, tp)
    want = ref["layers"].mlp(rl["mlp"], ref["jnp"].asarray(x), cfg.act)
    close(T_layers.mlp(tl["mlp"], tt(x), cfg.act), want)


def test_gelu_is_the_tanh_approximation(ref):
    """jax.nn.gelu's default is tanh; torch's erf form is 1e-3 away."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(ref["jax"].nn.gelu(ref["jnp"].asarray(x)))
    close(T_layers.act_fn("gelu")(tt(x)), want)
    assert np.abs(F.gelu(tt(x)).numpy() - want).max() > 1e-4


@pytest.mark.parametrize("theta,mrope", [(1e4, None), (1e5, None),
                                         (1e6, (16, 8, 8))])
def test_rope(theta, mrope, ref):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 64), np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    if mrope:
        pos = np.stack([pos, pos // 2, pos // 3], -1).astype(np.int32)
    want_ang = ref["rope"].rope_angles(ref["jnp"].asarray(pos), 64, theta,
                                       mrope)
    ang = T_rope.rope_angles(tt(pos), 64, theta, mrope)
    close(ang, want_ang, rtol=1e-6, atol=0)
    close(T_rope.apply_rope(tt(x), ang),
          ref["rope"].apply_rope(ref["jnp"].asarray(x), want_ang))


def test_attention_prefill_ring_then_decode(pair, ref):
    """starcoder2's 64-slot ring: a prompt of 80 keeps its last 64
    tokens in slots pos % 64; a decode writes slot 80 % 64."""
    cfg, rp, tp = pair["starcoder2-3b"]
    rl, tl = layer0(rp, tp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 80, cfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(80, dtype=np.int32), (2, 80)).copy()
    jnp = ref["jnp"]
    ry, rc = ref["attention"].attention_prefill(
        cfg, rl["attn"], jnp.asarray(x), jnp.asarray(pos), make_cache=True,
        cache_len=96)
    ty, tc = T_attn.attention_prefill(cfg, tl["attn"], tt(x), tt(pos),
                                      make_cache=True, cache_len=96)
    close(ty, ry)
    assert tc.k.shape == (2, 64, cfg.n_kv_heads, 64)
    for name in ("k", "v"):
        close(getattr(tc, name), getattr(rc, name))
    assert np.array_equal(tc.slot_pos.numpy(), np.asarray(rc.slot_pos))
    assert tc.slot_pos[0, 80 % 64].item() == 80 - 64
    x1 = rng.standard_normal((2, 1, cfg.d_model), np.float32)
    p1 = np.full((2, 1), 80, np.int32)
    ry, rc = ref["attention"].attention_decode(
        cfg, rl["attn"], jnp.asarray(x1), jnp.asarray(p1), rc)
    ty, tc2 = T_attn.attention_decode(cfg, tl["attn"], tt(x1), tt(p1), tc)
    assert tc2.k is tc.k                          # written in place
    close(ty, ry)
    close(tc.k, rc.k)
    assert np.array_equal(tc.slot_pos.numpy(), np.asarray(rc.slot_pos))


@pytest.mark.parametrize("arch,s", [("starcoder2-3b", 80),
                                    ("starcoder2-3b", 20), ("glm4-9b", 24)])
def test_prefill_then_three_decode_steps(arch, s, pair, ref):
    cfg, rp, tp = pair[arch]
    models = ref["models"]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    jb, tb = batch(ref, toks)
    rl, rcs = models.prefill(cfg, rp, jb, cache_len=96)
    tl, tcs = prefill(cfg, tp, tb, cache_len=96)
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, cfg.vocab_size)
    close(tl, rl)
    for step in range(3):
        nxt = np.asarray(rl[:, -1].argmax(-1)).astype(np.int32)[:, None]
        jb, tb = batch(ref, nxt, pos0=s + step)
        rl, rcs = models.decode_step(cfg, rp, jb, rcs)
        tl, tcs = decode_step(cfg, tp, tb, tcs)
        close(tl, rl)
    for i, c in enumerate(tcs):
        close(c.k, rcs.k[i])
        close(c.v, rcs.v[i])
        assert np.array_equal(c.slot_pos.numpy(), np.asarray(rcs.slot_pos[i]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train(arch, pair, ref):
    cfg, rp, tp = pair[arch]
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 70)).astype(np.int32)
    jb, tb = batch(ref, toks)
    want, _ = ref["models"].forward_train(cfg, rp, jb, remat=False)
    got, aux = forward_train(cfg, tp, tb)
    assert got.dtype == torch.float32 and got.shape == (2, 70,
                                                        cfg.vocab_size)
    close(got, want)


def test_checkpoint_file_and_bf16_bits(ref, tmp_path):
    """The flat-key ``.npz`` of ``repro.checkpoint`` converts to the same
    params as the nested tree, and bf16 weights arrive bit for bit."""
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              dtype="bfloat16")
    rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(7))
    path = ref["ckpt"].save_checkpoint(str(tmp_path), 1, rp)
    got = load_reference_checkpoint(path, cfg, "cpu")
    ref_np = ref["jax"].tree_util.tree_map(np.asarray, rp)
    nested = params_from_reference(ref_np, cfg, "cpu")
    wq = got["layers"][1]["attn"]["wq"]["w"]
    assert wq.dtype == torch.bfloat16
    assert np.array_equal(wq.view(torch.int16).numpy().view(np.uint16),
                          ref_np["layers"]["attn"]["wq"]["w"][1]
                          .view(np.uint16))
    assert torch.equal(nested["embed"]["emb"], got["embed"]["emb"])
    flat = {k: v for k, v in np.load(path).items()}
    flat["layers/attn/wq/w"] = flat["layers/attn/wq/w"][:1]
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(flat, cfg, "cpu")
    del flat["embed/emb"]
    with pytest.raises(KeyError, match="embed/emb"):
        params_from_reference(flat, cfg, "cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_width_param_shapes_match_reference(arch, ref):
    """At full width, from shapes only (``jax.eval_shape`` / ``meta``),
    for every config the repo ships (kimi-k2's trillion-parameter tree
    included): the dense, MoE, VLM and RWKV stacks and whisper's encoder
    and decoder stacks with the reference's leading layer axis, the
    hybrid's list (``None`` at the shared block's positions) as it
    is."""
    cfg = get_config(arch)
    jax = ref["jax"]
    shapes = jax.eval_shape(lambda: ref["models"].init_params(
        cfg, jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(str(p.key if hasattr(p, "key") else p.idx)
                       for p in path)
        want[key] = (tuple(leaf.shape), str(leaf.dtype))
    from repro_torch.checkpoint.convert import flatten, stacked_keys
    meta = init_params(cfg, device="meta")
    stacked = stacked_keys(cfg, meta)
    assert stacked == ([] if cfg.arch_type == "hybrid" else
                       ["enc_layers", "dec_layers"]
                       if cfg.is_encoder_decoder else ["layers"])
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in flatten({k: v for k, v in meta.items()
                                if k not in stacked}).items()}
    for name in stacked:
        for k, v in flatten(meta[name][0]).items():
            got[f"{name}/{k}"] = ((len(meta[name]), *v.shape),
                                  str(v.dtype).removeprefix("torch."))
    assert got == want
    assert all(t.device.type == "meta" for t in flatten(meta).values())


def test_default_device_is_cuda(monkeypatch):
    """Without CUDA the model inits raise rather than fall back, the
    decoder stacks' and whisper's alike."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("glm4-9b", "whisper-medium"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(get_config(arch).reduced())


# ---------------------------------------------------------------------------
# the recurrent families: zamba2 (hybrid) and rwkv6 (ssm)
# ---------------------------------------------------------------------------

def rec_layer(rp, tp, i):
    """Layer ``i``'s params on both sides (the reference's RWKV stack is
    stacked, its hybrid a list)."""
    import jax
    rl = rp["layers"][i] if isinstance(rp["layers"], list) else \
        jax.tree_util.tree_map(lambda a: a[i], rp["layers"])
    return rl, tp["layers"][i]


@pytest.mark.parametrize("s", [2, 9])
def test_mamba_block_prefill_then_decode(s, rec, ref):
    """``ssm_prefill`` with its cache (S=2 is shorter than the conv's
    history, which is then left-padded), then two ``ssm_decode`` steps."""
    from repro.models import ssm as R_ssm
    from repro_torch.models import ssm as T_ssm
    cfg, rp, tp = rec["zamba2-1.2b"]
    rl, tl = rec_layer(rp, tp, 0)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, s, cfg.d_model), np.float32)
    jnp = ref["jnp"]
    ry, rc = R_ssm.ssm_prefill(cfg, rl["ssm"], jnp.asarray(x),
                               make_cache=True)
    ty, tc = T_ssm.ssm_prefill(cfg, tl["ssm"], tt(x), make_cache=True)
    close(ty, ry)
    assert tc.conv.shape == (2, cfg.ssm_conv_width - 1,
                             T_ssm._dims(cfg)[2])
    close(tc.conv, rc.conv)
    close(tc.h, rc.h)
    for _ in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model), np.float32)
        ry, rc = R_ssm.ssm_decode(cfg, rl["ssm"], jnp.asarray(x1), rc)
        ty, tc = T_ssm.ssm_decode(cfg, tl["ssm"], tt(x1), tc)
        close(ty, ry)
        close(tc.conv, rc.conv)
        close(tc.h, rc.h)


def test_softplus_is_logaddexp(ref):
    from repro_torch.models.ssm import softplus
    x = np.linspace(-30, 30, 121, dtype=np.float32)
    close(softplus(tt(x)), ref["jax"].nn.softplus(ref["jnp"].asarray(x)))


def test_rwkv_time_and_channel_mix(rec, ref):
    """A 7-token pass from no state, then one token from the carried
    shifts and WKV state."""
    from repro.models import rwkv as R_rwkv
    from repro_torch.models import rwkv as T_rwkv
    cfg, rp, tp = rec["rwkv6-7b"]
    rl, tl = rec_layer(rp, tp, 1)
    rng = np.random.default_rng(11)
    jnp = ref["jnp"]
    x = rng.standard_normal((2, 7, cfg.d_model), np.float32)
    ry, rlast, rst = R_rwkv.time_mix(cfg, rl["rwkv"], jnp.asarray(x), None,
                                     None)
    ty, tlast, tst = T_rwkv.time_mix(cfg, tl["rwkv"], tt(x), None, None)
    for got, want in ((ty, ry), (tlast, rlast), (tst, rst)):
        close(got, want)
    x1 = rng.standard_normal((2, 1, cfg.d_model), np.float32)
    ry, _, rst = R_rwkv.time_mix(cfg, rl["rwkv"], jnp.asarray(x1), rlast,
                                 rst)
    ty, _, tst = T_rwkv.time_mix(cfg, tl["rwkv"], tt(x1), tlast, tst)
    close(ty, ry)
    close(tst, rst)
    ry, rlast = R_rwkv.channel_mix(cfg, rl["rwkv"], jnp.asarray(x), None)
    ty, tlast = T_rwkv.channel_mix(cfg, tl["rwkv"], tt(x), None)
    close(ty, ry)
    ry, _ = R_rwkv.channel_mix(cfg, rl["rwkv"], jnp.asarray(x1), rlast)
    ty, _ = T_rwkv.channel_mix(cfg, tl["rwkv"], tt(x1), tlast)
    close(ty, ry)


def close_caches(cfg, tcs, rcs):
    """The port's per-layer caches against the reference's: a list by
    layer for the hybrid, one stacked ``RWKVCache`` for rwkv."""
    assert len(tcs) == cfg.n_layers
    for i, (kind, c) in enumerate(zip(cfg.layer_kinds(), tcs)):
        want = rcs[i] if cfg.arch_type == "hybrid" else \
            type(rcs)(*(a[i] for a in rcs))
        assert type(c).__name__ == type(want).__name__, (i, kind)
        for name, got in c._asdict().items():
            if got.dtype == torch.int32:
                assert np.array_equal(got.numpy(),
                                      np.asarray(getattr(want, name)))
            else:
                # a recurrent state is a sum over the sequence of terms of
                # its own size, so its rounding error scales with its
                # largest entry, not with each entry
                want_a = np.asarray(getattr(want, name))
                close(got, want_a, rtol=1e-5,
                      atol=1e-5 * max(1.0, float(np.abs(want_a).max())))


@pytest.mark.parametrize("name,s", [("zamba2-1.2b", 20), ("zamba2-1.2b", 2),
                                    ("zamba2-4-layers", 20),
                                    ("rwkv6-7b", 20)])
def test_recurrent_prefill_then_three_decode_steps(name, s, rec, ref):
    cfg, rp, tp = rec[name]
    models = ref["models"]
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    jb, tb = batch(ref, toks)
    rl, rcs = models.prefill(cfg, rp, jb, cache_len=64)
    tl, tcs = prefill(cfg, tp, tb, cache_len=64)
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, cfg.vocab_size)
    close(tl, rl)
    close_caches(cfg, tcs, rcs)
    for step in range(3):
        nxt = np.asarray(rl[:, -1].argmax(-1)).astype(np.int32)[:, None]
        jb, tb = batch(ref, nxt, pos0=s + step)
        rl, rcs = models.decode_step(cfg, rp, jb, rcs)
        tl, tcs = decode_step(cfg, tp, tb, tcs)
        close(tl, rl)
    close_caches(cfg, tcs, rcs)
    if cfg.arch_type == "hybrid":    # one cache a position of the block
        attn = [c for c in tcs if hasattr(c, "slot_pos")]
        assert len(attn) == cfg.layer_kinds().count("attn")
        assert len({id(c.k) for c in attn}) == len(attn)


@pytest.mark.parametrize("name", sorted(RECURRENT))
def test_recurrent_forward_train(name, rec, ref):
    cfg, rp, tp = rec[name]
    toks = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 30)).astype(np.int32)
    jb, tb = batch(ref, toks)
    want, _ = ref["models"].forward_train(cfg, rp, jb, remat=False)
    got, _ = forward_train(cfg, tp, tb)
    assert got.shape == (2, 30, cfg.vocab_size)
    close(got, want)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_checkpoint_list_and_stacked_layouts(arch, ref, tmp_path):
    """A reference checkpoint ``.npz`` of the hybrid's list layout
    (``layers/<i>/...``, no key at the shared block's positions) and of
    the RWKV stack (a leading layer axis) converts to the nested tree's
    params, bf16 bit for bit; a missing or extra key raises."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(8))
    path = ref["ckpt"].save_checkpoint(str(tmp_path), 1, rp)
    got = load_reference_checkpoint(path, cfg, "cpu")
    ref_np = ref["jax"].tree_util.tree_map(np.asarray, rp)
    nested = params_from_reference(ref_np, cfg, "cpu")
    from repro_torch.checkpoint.convert import flatten
    assert flatten(got).keys() == flatten(nested).keys()
    for k, v in flatten(got).items():
        assert torch.equal(v, flatten(nested)[k]), k
    if cfg.arch_type == "hybrid":
        assert [lp is None for lp in got["layers"]] == \
            [k == "attn" for k in cfg.layer_kinds()]
        w, want = got["layers"][0]["ssm"]["in_proj"]["w"], \
            ref_np["layers"][0]["ssm"]["in_proj"]["w"]
        missing = "layers/0/ssm/conv_w"
        extra = "layers/1/ssm/conv_w"
    else:
        w, want = got["layers"][1]["rwkv"]["wk"]["w"], \
            ref_np["layers"]["rwkv"]["wk"]["w"][1]
        missing = "layers/rwkv/u"
        extra = "layers/0/rwkv/u"
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.view(torch.int16).numpy().view(np.uint16),
                          want.view(np.uint16))
    flat = {k: v for k, v in np.load(path).items()}
    flat[extra] = flat[missing]
    with pytest.raises(KeyError, match="does not know"):
        params_from_reference(flat, cfg, "cpu")
    del flat[missing]
    with pytest.raises(KeyError, match=missing):
        params_from_reference(flat, cfg, "cpu")
