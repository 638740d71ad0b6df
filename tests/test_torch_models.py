"""The port's dense model stack against the JAX reference, on the CPU.

Reduced starcoder2-3b (LayerNorm, tanh-GELU MLP, QKV bias, a 64-token
sliding window) and glm4-9b (RMSNorm, gated SiLU) in f32, with the
reference's weights carried across by ``repro_torch.checkpoint``.  Inputs
come from a numpy seed.  Tolerance: 1e-5 absolute and relative in f32 —
both sides compute in f32 and differ only in summation order and in the
last ulp of ``pow``/``exp``/``tanh``; a tanh-vs-erf GELU mix-up (~1e-3)
or a lost window lies far outside it.  The reference is imported inside
fixtures, so the file also collects where JAX is absent.
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
from repro_torch.models.transformer import check_supported

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("starcoder2-3b", "glm4-9b")


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


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).arch_type == "dense"])
def test_full_width_param_shapes_match_reference(arch, ref):
    """At full width, from shapes only (``jax.eval_shape`` / ``meta``)."""
    cfg = get_config(arch)
    jax = ref["jax"]
    shapes = jax.eval_shape(lambda: ref["models"].init_params(
        cfg, jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(str(p.key) for p in path)
        want[key] = (tuple(leaf.shape), str(leaf.dtype))
    from repro_torch.checkpoint.convert import flatten
    meta = init_params(cfg, device="meta")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in flatten({k: v for k, v in meta.items()
                                if k != "layers"}).items()}
    for k, v in flatten(meta["layers"][0]).items():
        got[f"layers/{k}"] = ((cfg.n_layers, *v.shape),
                              str(v.dtype).removeprefix("torch."))
    assert got == want
    assert all(t.device.type == "meta" for t in
               flatten(dict(meta, layers=meta["layers"][0])).values())


@pytest.mark.parametrize("arch,item", [
    ("granite-moe-1b-a400m", "moe.py"), ("zamba2-1.2b", "B4"),
    ("rwkv6-7b", "B5"), ("qwen2-vl-7b", "VLM"), ("whisper-medium", "whisper")])
def test_other_families_raise_naming_their_item(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        check_supported(get_config(arch).reduced())
    with pytest.raises(NotImplementedError, match=item):
        init_params(get_config(arch).reduced(), device="cpu")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(get_config("glm4-9b").reduced())
