"""The port's MoE layer and MoE model stacks against the JAX reference, on
the CPU.

Reduced granite-moe-1b-a400m (4 experts, top 2) and kimi-k2-1t-a32b (4
experts with a shared expert, and a 64-expert variant for the reference's
smaller group size at E >= 64), in f32, with the reference's weights
carried across by ``repro_torch.checkpoint``.  ``moe_apply`` must keep
exactly the reference's (token, choice) pairs: the top-k experts and the
capacity mask are compared for equality, with the reference's routing
computed by its own lines (``repro/models/moe.py``: router logits,
softmax, ``lax.top_k``, the exclusive cumsum of the one-hot choices);
``y``, the aux loss and the router entropy within ``TOL``, the bound of
``tests/test_torch_models.py`` (both sides compute in f32 and differ in
summation order only).  The reference is imported inside fixtures, so
the file also collects where JAX is absent.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (load_reference_checkpoint,
                                    params_from_reference)
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward_train, init_params,
                                prefill)
from repro_torch.models import moe as T_moe

TOL = dict(rtol=1e-5, atol=1e-5)
#: name: the reduced config of each MoE case.
CFGS = {
    "granite-moe": lambda: get_config("granite-moe-1b-a400m").reduced(),
    "kimi-k2": lambda: get_config("kimi-k2-1t-a32b").reduced(),
    "kimi-k2-64e": lambda: dataclasses.replace(
        get_config("kimi-k2-1t-a32b").reduced(), n_experts=64),
}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.checkpoint as ckpt
    import repro.models as models
    from repro.models import moe
    return dict(jax=jax, jnp=jnp, models=models, moe=moe, ckpt=ckpt)


@pytest.fixture(scope="module")
def pair(ref):
    """Per ``CFGS`` name: (cfg, reference params, the port's params)."""
    out = {}
    for name, make in CFGS.items():
        cfg = make()
        rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(5))
        tp = params_from_reference(
            ref["jax"].tree_util.tree_map(np.asarray, rp), cfg, "cpu")
        out[name] = (cfg, rp, tp)
    return out


def tt(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def moe_params(ref, rp, tp, layer=0):
    return ref["jax"].tree_util.tree_map(lambda a: a[layer],
                                         rp["layers"]["moe"]), \
        tp["layers"][layer]["moe"]


def ref_routing(ref, cfg, p, x, group_size=None):
    """The reference's routing, by its own lines: (topk_e [G,Sg,K], keep
    [G,Sg,K]) as numpy."""
    jax, jnp = ref["jax"], ref["jnp"]
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    n_tok = b * s
    sg = group_size or min(n_tok, 1024 if e >= 64 else 4096)
    sg = min(sg, n_tok)
    while n_tok % sg:
        sg //= 2
    g = n_tok // sg
    xg = jnp.asarray(x).reshape(g, sg, d)
    c = sg if s == 1 else ref["moe"]._capacity(sg, cfg)
    probs = jax.nn.softmax(xg.astype(jnp.float32) @ p["router"]["w"], -1)
    _, topk_e = jax.lax.top_k(probs, k)
    sel = jax.nn.one_hot(topk_e, e, dtype=jnp.int32)
    flat = sel.reshape(g, sg * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(g, sg, k, e)
                  * sel, axis=-1)
    return np.asarray(topk_e), np.asarray(pos < c), (g, sg, c)


#: name: (config, B, S, group_size) of each ``moe_apply`` case.
MOE_CASES = {
    "prefill-drops": ("granite-moe", 2, 40, None),
    "groups": ("granite-moe", 2, 24, 16),
    "ragged-groups": ("granite-moe", 2, 2500, None),
    "decode": ("granite-moe", 2, 1, None),
    "shared-expert": ("kimi-k2", 2, 24, None),
    "64-experts": ("kimi-k2-64e", 2, 40, None),
    "64-experts-ragged": ("kimi-k2-64e", 2, 600, None),
    "64-experts-decode": ("kimi-k2-64e", 3, 1, None),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case, pair, ref):
    name, b, s, gs = MOE_CASES[case]
    cfg, rp, tp = pair[name]
    rl, tl = moe_params(ref, rp, tp)
    x = np.random.default_rng(len(case)).standard_normal(
        (b, s, cfg.d_model), np.float32)
    if case == "prefill-drops":     # a common direction: popular experts
        x += 1.0
    want_e, want_keep, (g, sg, c) = ref_routing(ref, cfg, rl, x, gs)
    _, _, got_e, _, got_keep = T_moe._route(
        cfg, tl, tt(x).reshape(g, sg, cfg.d_model), c)
    assert np.array_equal(got_e.numpy(), want_e)
    assert np.array_equal(got_keep.numpy(), want_keep)
    if case in ("prefill-drops", "64-experts", "64-experts-ragged"):
        assert not want_keep.all(), "the case must drop some pairs"
    if "decode" in case:
        assert want_keep.all() and c == sg
    if case in ("groups", "ragged-groups", "64-experts-ragged"):
        assert g > 1 and (gs or b * s) % sg == 0
    if "ragged" in case:
        default = 1024 if cfg.n_experts >= 64 else 4096
        assert (b * s) % min(b * s, default)
    want = ref["moe"].moe_apply(cfg, rl, ref["jnp"].asarray(x),
                                group_size=gs)
    got = T_moe.moe_apply(cfg, tl, tt(x), group_size=gs)
    assert got.y.shape == (b, s, cfg.d_model) and got.y.dtype == torch.float32
    close(got.y, want.y)
    close(got.aux_loss, want.aux_loss)
    close(got.router_entropy, want.router_entropy)


def test_ties_keep_the_lower_expert():
    """Equal router probabilities: the lower expert index first, as
    ``jax.lax.top_k`` orders them, so the capacity order matches."""
    cfg = dataclasses.replace(CFGS["granite-moe"](), n_experts=4,
                              experts_per_token=2, capacity_factor=1.0)
    p = {"router": {"w": torch.zeros(cfg.d_model, 4)}}
    x = torch.randn(1, 6, cfg.d_model)
    probs, topk_p, topk_e, pos, keep = T_moe._route(cfg, p, x, 3)
    assert topk_e.tolist() == [[[0, 1]] * 6]
    assert pos[0, :, 0].tolist() == list(range(6))
    assert keep[0, :, 0].tolist() == [True] * 3 + [False] * 3
    close(topk_p, np.full((1, 6, 2), 0.5, np.float32))


def test_bf16_dispatch_rounds_the_gate(ref):
    """In bf16 the gate is rounded to bf16 before the f32 combine and the
    output comes back in bf16, as in the reference."""
    cfg = dataclasses.replace(CFGS["granite-moe"](), dtype="bfloat16")
    rp = ref["moe"].moe_init(ref["jax"].random.PRNGKey(2), cfg)
    flat = ref["jax"].tree_util.tree_map(np.asarray, rp)
    tp = {"router": {"w": tt(flat["router"]["w"])}}
    for k in ("gate", "up", "down"):
        tp[k] = torch.from_numpy(flat[k].view(np.int16).copy()).view(
            torch.bfloat16)
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model),
                                                 np.float32)
    xb = ref["jnp"].asarray(x).astype(ref["jnp"].bfloat16)
    want = ref["moe"].moe_apply(cfg, rp, xb)
    got = T_moe.moe_apply(cfg, tp, tt(x).to(torch.bfloat16))
    assert got.y.dtype == torch.bfloat16
    close(got.y.float(), np.asarray(want.y.astype(np.float32)),
          rtol=2e-2, atol=2e-2)


def batch(ref, tokens, pos0=0):
    b, s = tokens.shape
    pos = np.broadcast_to(np.arange(pos0, pos0 + s, dtype=np.int32),
                          (b, s)).copy()
    items = (("tokens", tokens), ("positions", pos), ("seq_positions", pos))
    return ({k: ref["jnp"].asarray(v) for k, v in items},
            {k: tt(v) for k, v in items})


@pytest.mark.parametrize("name,s", [("granite-moe", 24), ("granite-moe", 5),
                                    ("kimi-k2", 24), ("kimi-k2-64e", 20)])
def test_prefill_then_three_decode_steps(name, s, pair, ref):
    cfg, rp, tp = pair[name]
    models = ref["models"]
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    jb, tb = batch(ref, toks)
    rl, rcs = models.prefill(cfg, rp, jb, cache_len=48)
    tl, tcs = prefill(cfg, tp, tb, cache_len=48)
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


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_train_and_aux(name, pair, ref):
    """Logits, and ``Aux``: the aux loss summed over the layers and the
    router entropy averaged over them."""
    cfg, rp, tp = pair[name]
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 30)).astype(np.int32)
    jb, tb = batch(ref, toks)
    want, want_aux = ref["models"].forward_train(cfg, rp, jb, remat=False)
    got, aux = forward_train(cfg, tp, tb)
    assert got.shape == (2, 30, cfg.vocab_size)
    close(got, want)
    close(aux.moe_aux, want_aux.moe_aux)
    close(aux.router_entropy, want_aux.router_entropy)
    assert float(aux.moe_aux) > 0 and float(aux.router_entropy) > 0


def test_dense_aux_is_zero():
    cfg = get_config("glm4-9b").reduced()
    tp = init_params(cfg, device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    _, aux = forward_train(cfg, tp, {"tokens": toks,
                                     "positions": toks})
    assert float(aux.moe_aux) == 0 and float(aux.router_entropy) == 0


def test_checkpoint_file_carries_the_moe_tree(ref, tmp_path):
    """A reference ``.npz`` of a bf16 MoE model with a shared expert
    converts to the nested tree's params: the router in f32, the experts
    ``[E, din, dout]`` a layer, bf16 bit for bit."""
    cfg = dataclasses.replace(CFGS["kimi-k2"](), dtype="bfloat16")
    rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(8))
    path = ref["ckpt"].save_checkpoint(str(tmp_path), 1, rp)
    got = load_reference_checkpoint(path, cfg, "cpu")
    ref_np = ref["jax"].tree_util.tree_map(np.asarray, rp)
    moe = got["layers"][1]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["gate"].shape == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert moe["down"].shape == (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)
    assert set(moe["shared"]) == {"gate", "up", "down"}
    for k in ("gate", "down"):
        assert np.array_equal(
            moe[k].view(torch.int16).numpy().view(np.uint16),
            ref_np["layers"]["moe"][k][1].view(np.uint16))
    assert np.array_equal(moe["router"]["w"].numpy(),
                          ref_np["layers"]["moe"]["router"]["w"][1])


def test_expert_init_draws_a_layer_in_its_dtype():
    """``moe_init`` draws the experts one at a time: each expert's
    weights have the scale ``din ** -0.5`` and differ from the next's."""
    cfg = dataclasses.replace(CFGS["kimi-k2-64e"](), dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = T_moe.moe_init(gen, cfg)
    assert p["gate"].dtype == torch.bfloat16
    assert p["router"]["w"].dtype == torch.float32
    std = p["gate"].float().std(dim=(1, 2))
    assert torch.allclose(std, torch.full_like(std, cfg.d_model ** -0.5),
                          rtol=0.05)
    assert not torch.equal(p["up"][0], p["up"][1])
    meta = T_moe.moe_init(None, cfg, device="meta")
    assert meta["down"].shape == (64, cfg.moe_d_ff, cfg.d_model)
