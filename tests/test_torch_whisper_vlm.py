"""The port's whisper encoder-decoder and qwen2-vl (M-RoPE with spliced
vision patches) against the JAX reference, on the CPU.

Reduced whisper-medium (2 encoder and 2 decoder layers over 64 frames,
LayerNorm, tanh-GELU, tied head, learned decoder positions) and reduced
qwen2-vl-7b (QKV bias, M-RoPE sections rescaled to the head dim of 64),
in f32, with the reference's weights carried across by
``repro_torch.checkpoint``.  Both packages get the same numpy inputs:
frame embeddings, patch embeddings and 3-D positions are drawn once by
the reference's stubs and fed to both.  Tolerance ``TOL``, the bound of
``tests/test_torch_models.py``.  The reference is imported inside
fixtures, so the file also collects where JAX is absent.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (load_reference_checkpoint,
                                    params_from_reference)
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward_train, init_caches,
                                init_params, prefill)
from repro_torch.models import attention as T_attn
from repro_torch.models import frontends as T_front
from repro_torch.models import rope as T_rope
from repro_torch.models import whisper as T_wh

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("whisper-medium", "qwen2-vl-7b")


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.checkpoint as ckpt
    import repro.models as models
    from repro.models import attention, frontends, rope, whisper
    return dict(jax=jax, jnp=jnp, models=models, attention=attention,
                frontends=frontends, rope=rope, whisper=whisper, ckpt=ckpt)


@pytest.fixture(scope="module")
def pair(ref):
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(9))
        tp = params_from_reference(
            ref["jax"].tree_util.tree_map(np.asarray, rp), cfg, "cpu")
        out[arch] = (cfg, rp, tp)
    return out


def tt(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def frames(ref, cfg, b=2, seed=0):
    return np.asarray(ref["frontends"].stub_audio_frames(
        ref["jax"].random.PRNGKey(seed), cfg, b))


def both(ref, **arrays):
    """The same inputs as a reference batch and a port batch."""
    return ({k: ref["jnp"].asarray(v) for k, v in arrays.items()},
            {k: tt(v) for k, v in arrays.items()})


def dec_layer0(ref, rp, tp, key="dec_layers"):
    return ref["jax"].tree_util.tree_map(lambda a: a[0], rp[key]), \
        tp[key][0]


# ---------------------------------------------------------------------------
# whisper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 7])
def test_cross_attention_and_cross_kv(s, pair, ref):
    """Keys and values of the encoder states, then queries of S = 1 (a
    decode step) and 7 tokens against all 64 frames, with no mask."""
    cfg, rp, tp = pair["whisper-medium"]
    rl, tl = dec_layer0(ref, rp, tp)
    rng = np.random.default_rng(s)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model), np.float32)
    x = rng.standard_normal((2, s, cfg.d_model), np.float32)
    jnp = ref["jnp"]
    rk, rv = ref["attention"].encode_cross_kv(cfg, rl["xattn"],
                                              jnp.asarray(enc))
    tk, tv = T_attn.encode_cross_kv(cfg, tl["xattn"], tt(enc))
    assert tk.shape == (2, cfg.encoder_seq, cfg.n_heads, 64)
    assert tk.is_contiguous() and tv.is_contiguous()
    close(tk, rk)
    close(tv, rv)
    want = ref["attention"].cross_attention(cfg, rl["xattn"], jnp.asarray(x),
                                            rk, rv)
    got = T_attn.cross_attention(cfg, tl["xattn"], tt(x), tk, tv)
    assert got.shape == (2, s, cfg.d_model)
    close(got, want)


def test_cross_attn_init_is_an_attention_block():
    cfg = get_config("whisper-medium").reduced()
    p = T_attn.cross_attn_init(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v["w"].shape) for k, v in p.items()} == {
        "wq": (256, 256), "wk": (256, 256), "wv": (256, 256),
        "wo": (256, 256)}


def test_encode(pair, ref):
    cfg, rp, tp = pair["whisper-medium"]
    fr = frames(ref, cfg, seed=1) * 50      # frames of unit scale
    want = ref["whisper"].encode(cfg, rp, ref["jnp"].asarray(fr))
    got = T_wh.encode(cfg, tp, tt(fr))
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    close(got, want)


def test_sinusoid(ref):
    """The reduced table within ``TOL``; whisper-medium's 1,500 x 1,024
    within one f32 ulp of its largest angle (1,499 rad: 1.22e-4), since
    the two packages' ``pow`` and ``sin`` may differ in the last ulp."""
    close(T_wh._sinusoid(64, 256), ref["whisper"]._sinusoid(64, 256))
    close(T_wh._sinusoid(1500, 1024), ref["whisper"]._sinusoid(1500, 1024),
          rtol=0, atol=2.0 ** -13)


def test_dec_embed_wraps_positions(pair, ref):
    """Learned decoder positions at ``positions % max_target_positions``,
    as the reference takes them."""
    cfg, rp, tp = pair["whisper-medium"]
    toks = np.array([[3, 5, 7]], np.int32)
    pos = np.array([[0, cfg.max_target_positions, 2 * 128 + 5]], np.int32)
    want = ref["whisper"]._dec_embed(cfg, rp, ref["jnp"].asarray(toks),
                                     ref["jnp"].asarray(pos))
    got = T_wh._dec_embed(cfg, tp, tt(toks), tt(pos))
    close(got, want)
    assert np.array_equal(T_wh._dec_positions(tt(toks), 4).numpy(),
                          np.asarray(ref["whisper"]._dec_positions(
                              ref["jnp"].asarray(toks), 4)))


@pytest.mark.parametrize("s", [5, 20])
def test_whisper_prefill_then_three_decode_steps(s, pair, ref):
    cfg, rp, tp = pair["whisper-medium"]
    models = ref["models"]
    rng = np.random.default_rng(s)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    jb, tb = both(ref, tokens=toks, frame_embeds=frames(ref, cfg, seed=s))
    rl, rcs = models.prefill(cfg, rp, jb, cache_len=40)
    tl, tcs = prefill(cfg, tp, tb, cache_len=40)
    assert isinstance(tcs, T_wh.WhisperCache)
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, cfg.vocab_size)
    close(tl, rl)
    for i in range(cfg.n_layers):
        close(tcs.cross_k[i], rcs.cross_k[i])
        close(tcs.cross_v[i], rcs.cross_v[i])
    for step in range(3):
        nxt = np.asarray(rl[:, -1].argmax(-1)).astype(np.int32)[:, None]
        pos = np.full((2, 1), s + step, np.int32)
        jb, tb = both(ref, tokens=nxt, positions=pos)
        rl, rcs = models.decode_step(cfg, rp, jb, rcs)
        tl, tcs = decode_step(cfg, tp, tb, tcs)
        close(tl, rl)
    for i, c in enumerate(tcs.self_caches):
        close(c.k, rcs.self_caches.k[i])
        close(c.v, rcs.self_caches.v[i])
        assert np.array_equal(c.slot_pos.numpy(),
                              np.asarray(rcs.self_caches.slot_pos[i]))


def test_whisper_forward_train(pair, ref):
    """``decode_train`` through the facade: f32 logits and a zero Aux."""
    cfg, rp, tp = pair["whisper-medium"]
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 30)).astype(np.int32)
    jb, tb = both(ref, tokens=toks, frame_embeds=frames(ref, cfg, seed=4))
    want, _ = ref["models"].forward_train(cfg, rp, jb, remat=False)
    got, aux = forward_train(cfg, tp, tb)
    assert got.shape == (2, 30, cfg.vocab_size)
    close(got, want)
    assert float(aux.moe_aux) == 0 and float(aux.router_entropy) == 0


def test_whisper_init_caches_match_reference(ref):
    cfg = get_config("whisper-medium").reduced()
    want = ref["models"].init_caches(cfg, 2, 48, dtype=ref["jnp"].float32)
    got = init_caches(cfg, 2, 48, dtype=torch.float32, device="cpu")
    assert len(got.self_caches) == len(got.cross_k) == cfg.n_layers
    assert got.self_caches[0].k.shape == want.self_caches.k.shape[1:]
    assert got.cross_k[1].shape == want.cross_k.shape[1:]
    assert (got.self_caches[1].slot_pos == -1).all()
    assert float(got.cross_v[0].abs().sum()) == 0


def test_whisper_checkpoint_file_carries_the_tree(ref, tmp_path):
    """A reference ``.npz`` of bf16 whisper: ``tok_embed``, ``pos_embed``,
    the stacked ``enc_layers``/``dec_layers`` (with ``xattn``) unstacked
    bit for bit, the norms in f32; a missing key raises."""
    cfg = dataclasses.replace(get_config("whisper-medium").reduced(),
                              dtype="bfloat16")
    rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(10))
    path = ref["ckpt"].save_checkpoint(str(tmp_path), 1, rp)
    got = load_reference_checkpoint(path, cfg, "cpu")
    ref_np = ref["jax"].tree_util.tree_map(np.asarray, rp)
    assert len(got["enc_layers"]) == cfg.n_encoder_layers
    assert len(got["dec_layers"]) == cfg.n_layers
    for key, sub in (("dec_layers", ("xattn", "wk")),
                     ("enc_layers", ("attn", "wo"))):
        w = got[key][1][sub[0]][sub[1]]["w"]
        assert w.dtype == torch.bfloat16
        assert np.array_equal(w.view(torch.int16).numpy().view(np.uint16),
                              ref_np[key][sub[0]][sub[1]]["w"][1]
                              .view(np.uint16))
    assert got["dec_norm"]["b"].dtype == torch.float32
    assert np.array_equal(
        got["pos_embed"].view(torch.int16).numpy().view(np.uint16),
        ref_np["pos_embed"].view(np.uint16))
    flat = {k: v for k, v in np.load(path).items()}
    del flat["dec_layers/xattn/wq/w"]
    with pytest.raises(KeyError, match="dec_layers/xattn/wq/w"):
        params_from_reference(flat, cfg, "cpu")


def test_stub_audio_frames():
    cfg = get_config("whisper-medium")
    fr = T_front.stub_audio_frames(torch.Generator().manual_seed(0), cfg, 2)
    assert fr.shape == (2, 1500, 1024) and fr.dtype == torch.float32
    assert abs(float(fr.std()) - 0.02) < 1e-3
    half = T_front.stub_audio_frames(torch.Generator().manual_seed(0),
                                     cfg.reduced(), 1, torch.bfloat16,
                                     "cpu")
    assert half.shape == (1, 64, 256) and half.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# qwen2-vl: M-RoPE over spliced vision patches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_patches,seq", [(16, 32), (9, 20), (1, 4)])
def test_stub_vision_patches_positions(n_patches, seq, ref):
    """The (t, h, w) grid over the patch span, text resuming after it,
    and the patch positions, equal to the reference's; the embeddings'
    shape and scale."""
    cfg = get_config("qwen2-vl-7b").reduced()
    _, want_pp, want_pos = ref["frontends"].stub_vision_patches(
        ref["jax"].random.PRNGKey(0), cfg, 2, n_patches, seq)
    emb, pp, pos = T_front.stub_vision_patches(
        torch.Generator().manual_seed(0), cfg, 2, n_patches, seq)
    assert np.array_equal(pp.numpy(), np.asarray(want_pp))
    assert np.array_equal(pos.numpy(), np.asarray(want_pos))
    assert pos.dtype == pp.dtype == torch.int32
    assert emb.shape == (2, n_patches, cfg.d_model)
    if n_patches > 1:
        assert abs(float(emb.std()) - 0.02) < 4e-3


def test_text_positions(ref):
    for fn in ("text_positions", "mrope_text_positions"):
        want = getattr(ref["rope"], fn)(2, 5, 7)
        got = getattr(T_rope, fn)(2, 5, 7, device="cpu")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want)), fn


def vlm_inputs(ref, cfg, s, n_patches, seed, extra=3):
    """Tokens, patch embeddings, patch positions and the 3-D positions of
    ``s + extra`` tokens (the prompt's and the decode steps'), from the
    reference's stub."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    emb, pp, pos = (np.asarray(a) for a in
                    ref["frontends"].stub_vision_patches(
                        ref["jax"].random.PRNGKey(seed), cfg, 2, n_patches,
                        s + extra))
    return toks, emb * 50, pp, pos


@pytest.mark.parametrize("s,n_patches", [(20, 9), (12, 4)])
def test_vlm_prefill_then_three_decode_steps(s, n_patches, pair, ref):
    """Patches spliced over the first tokens, M-RoPE positions from the
    stub's grid, explicit ``seq_positions``; then three decode steps at
    the text positions that follow."""
    cfg, rp, tp = pair["qwen2-vl-7b"]
    models = ref["models"]
    toks, emb, pp, pos = vlm_inputs(ref, cfg, s, n_patches, s)
    seq = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    jb, tb = both(ref, tokens=toks, patch_embeds=emb, patch_positions=pp,
                  positions=pos[:, :s], seq_positions=seq)
    rl, rcs = models.prefill(cfg, rp, jb, cache_len=40)
    tl, tcs = prefill(cfg, tp, tb, cache_len=40)
    close(tl, rl)
    for step in range(3):
        nxt = np.asarray(rl[:, -1].argmax(-1)).astype(np.int32)[:, None]
        jb, tb = both(ref, tokens=nxt,
                      positions=pos[:, s + step:s + step + 1],
                      seq_positions=np.full((2, 1), s + step, np.int32))
        rl, rcs = models.decode_step(cfg, rp, jb, rcs)
        tl, tcs = decode_step(cfg, tp, tb, tcs)
        close(tl, rl)
    for i, c in enumerate(tcs):
        close(c.k, rcs.k[i])
        assert np.array_equal(c.slot_pos.numpy(), np.asarray(rcs.slot_pos[i]))


def test_vlm_forward_train_splices_patches(pair, ref):
    """The patches change the logits (they are spliced, not ignored), and
    the port's logits with them equal the reference's."""
    cfg, rp, tp = pair["qwen2-vl-7b"]
    toks, emb, pp, pos = vlm_inputs(ref, cfg, 24, 16, 5, extra=0)
    jb, tb = both(ref, tokens=toks, patch_embeds=emb, patch_positions=pp,
                  positions=pos)
    want, _ = ref["models"].forward_train(cfg, rp, jb, remat=False)
    got, _ = forward_train(cfg, tp, tb)
    close(got, want)
    plain, _ = forward_train(cfg, tp, {"tokens": tb["tokens"],
                                       "positions": tb["positions"]})
    assert float((plain - got).abs().max()) > 1e-2


def test_vlm_decode_needs_seq_positions(pair):
    """M-RoPE decode with 3-D positions and no ``seq_positions`` raises
    (the temporal ids of patches collide), as the reference asserts."""
    cfg, _, tp = pair["qwen2-vl-7b"]
    toks = torch.zeros(2, 4, dtype=torch.int32)
    pos = T_rope.mrope_text_positions(2, 4, device="cpu")
    _, caches = prefill(cfg, tp, {"tokens": toks, "positions": pos},
                        cache_len=8)
    with pytest.raises(ValueError, match="seq_positions"):
        decode_step(cfg, tp, {"tokens": toks[:, :1],
                              "positions": pos[:, :1] + 4}, caches)


def test_inits_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCHS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(get_config(arch).reduced())
