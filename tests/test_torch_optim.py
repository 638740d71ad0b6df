"""The port's optimizers, data pipeline and checkpoints against the JAX
reference, on the CPU.

AdamW and Adafactor are fed *the same* numpy params, grads and state on
both sides (the reference's params carried across by
``params_from_reference``, the grads drawn from a numpy seed in the
reference's layout and unstacked the same way), for three updates in a
row, the port taking the reference's params and state before each.
Params and AdamW's moments must agree within 1e-6 of each leaf's largest
magnitude (both sides compute in f32; only the order of
``global_norm``'s and Adafactor's RMS sums differs, a few ulps),
Adafactor's factored moments within 2e-6 (``MOMENT_TOL``).  The configs
pin the stacked-leaf rule: reduced glm4-9b (dense), kimi-k2 (MoE,
experts stacked per layer), zamba2 (hybrid: its ``layers`` list is not
stacked) and whisper (two stacks).  Then the reference's
``tests/test_substrates.py`` cases on the port, the data batches
bitwise, and checkpoints: round trips (bf16 bit for bit, an optimizer
state's NamedTuple), the shape check, ``latest_step``, and f32 and int
files written by either package restored by the other.  The reference
is imported inside fixtures, so the file also collects where JAX is
absent.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (latest_step, params_from_reference,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.convert import flatten
from repro_torch.configs import get_config
from repro_torch.data import (DataConfig, batch_iterator, make_batch,
                              synthetic_corpus)
from repro_torch.models import init_params
from repro_torch.optim import (AdafactorState, AdamWState, get_optimizer,
                               global_norm)

TOL = 1e-6
#: Adafactor's factored moments are means over a leaf's rows or columns
#: (up to 1,024 f32 values, the reduced vocab) that XLA and torch sum in
#: another order, each ~1e-6 off the exact mean (1.32e-6 apart at most).
MOMENT_TOL = 2e-6
ARCHS = ("glm4-9b", "kimi-k2-1t-a32b", "zamba2-1.2b", "whisper-medium")


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.checkpoint as ckpt
    import repro.data as data
    import repro.models as models
    import repro.optim as optim
    return dict(jax=jax, jnp=jnp, ckpt=ckpt, data=data, models=models,
                optim=optim)


@pytest.fixture(scope="module")
def pairs(ref):
    """Per arch: (reduced cfg, reference params, the port's params)."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(11))
        tp = params_from_reference(
            ref["jax"].tree_util.tree_map(np.asarray, rp), cfg, "cpu")
        out[arch] = (cfg, rp, tp)
    return out


def ref_flat(ref, tree) -> dict:
    return {k: np.asarray(v) for k, v in ref["ckpt"].ckpt._flatten(
        tree).items()}


def stacked_flat(tree) -> dict:
    """The port's tree in the reference's layout (each list with no
    ``None`` stacked on a leading axis, but a hybrid's ``layers``, the
    list beside ``shared_attn``), flat, as numpy."""
    def lay(t, stack=True):
        if hasattr(t, "_fields"):
            t = t._asdict()
        if isinstance(t, dict):
            return {k: lay(v, not (k == "layers" and "shared_attn" in t))
                    for k, v in t.items()}
        if stack and isinstance(t, list) and t and all(
                e is not None for e in t):
            layers = [flatten(lay(e)) for e in t]
            return {k: np.stack([lp[k] for lp in layers]) for k in layers[0]}
        if isinstance(t, list):
            return [lay(e) for e in t]
        return t if t is None else t.detach().float().numpy()
    return flatten(lay(tree))


def close_flat(got: dict, want: dict, what: str, tol=TOL):
    assert sorted(got) == sorted(want), what
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = np.asarray(got[k], np.float32)
        assert g.shape == w.shape, (what, k)
        bound = tol * max(float(np.abs(w).max(initial=0.0)), 1e-30)
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= bound, f"{what} {k}: {err} > {bound}"


def draw_grads(ref, rp, seed):
    """Random grads in the reference's layout and dtypes."""
    rng = np.random.default_rng(seed)
    return ref["jax"].tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.3).astype(
            np.asarray(p).dtype), rp)


def port_state(ref, cfg, name, rs):
    """The reference's optimizer state as the port's: AdamW's moments
    unstacked as params are, Adafactor's kept in the reference's layout."""
    np_tree = ref["jax"].tree_util.tree_map(np.asarray, rs)
    step = torch.tensor(int(rs.step), dtype=torch.int32)
    if name == "adamw":
        return AdamWState(step, params_from_reference(np_tree.m, cfg, "cpu"),
                          params_from_reference(np_tree.v, cfg, "cpu"))
    to_t = lambda a: torch.from_numpy(np.array(a))          # noqa: E731
    return AdafactorState(
        step, ref["jax"].tree_util.tree_map(to_t, np_tree.vr),
        ref["jax"].tree_util.tree_map(to_t, np_tree.vc))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(lr=1e-2)),
    ("adafactor", dict(lr=1e-2, weight_decay=0.1))])
def test_update_matches_reference(arch, name, kw, pairs, ref):
    """Three updates in a row; before each, the port takes the
    reference's params and state, so each update is compared alone."""
    cfg, rp, _ = pairs[arch]
    ropt = ref["optim"].get_optimizer(name, **kw)
    topt = get_optimizer(name, **kw)
    rs = ropt.init(rp)
    for step in range(3):
        g = draw_grads(ref, rp, step)
        tp = params_from_reference(
            ref["jax"].tree_util.tree_map(np.asarray, rp), cfg, "cpu")
        ts = port_state(ref, cfg, name, rs)
        if step == 0:
            init = topt.init(tp)
            assert all(float(t.abs().max()) == 0 for t in
                       flatten(init).values() if t.numel())
            close_flat(stacked_flat(init), stacked_flat(ts), "init")
        rp, rs = ropt.update(rp, g, rs)
        tp, ts = topt.update(tp, params_from_reference(g, cfg, "cpu"), ts)
        close_flat(stacked_flat(tp), ref_flat(ref, rp), f"{arch} params")
        assert int(ts.step) == int(rs.step) == step + 1
        if name == "adamw":
            close_flat(stacked_flat(ts.m), ref_flat(ref, rs.m), "m")
            close_flat(stacked_flat(ts.v), ref_flat(ref, rs.v), "v")
        else:
            # the state is in the reference's layout, leaf for leaf
            close_flat(stacked_flat(ts.vr), ref_flat(ref, rs.vr), "vr",
                       MOMENT_TOL)
            close_flat(stacked_flat(ts.vc), ref_flat(ref, rs.vc), "vc",
                       MOMENT_TOL)


def test_adafactor_factors_the_stacked_leaves(pairs):
    """A per-layer norm scale [D] of a stacked list is factored as
    [L, D] (a row moment a layer, one column moment), a hybrid's Mamba
    layer's is not; MoE experts [E, din, dout] stack to [L, E, din,
    dout]."""
    opt = get_optimizer("adafactor")
    cfg, _, tp = pairs["kimi-k2-1t-a32b"]
    st = opt.init(tp)
    n, d = cfg.n_layers, cfg.d_model
    assert st.vr["layers"]["ln1"]["g"].shape == (n,)
    assert st.vc["layers"]["ln1"]["g"].shape == (d,)
    e, f = cfg.n_experts, cfg.moe_d_ff
    assert st.vr["layers"]["moe"]["gate"].shape == (n, e, d)
    assert st.vc["layers"]["moe"]["gate"].shape == (n, e, f)
    assert st.vr["final_norm"]["g"].shape == (d,)
    assert st.vc["final_norm"]["g"].shape == (0,)
    cfg, _, tp = pairs["zamba2-1.2b"]
    st = opt.init(tp)
    assert st.vr["layers"][0]["ln1"]["g"].shape == (cfg.d_model,)
    assert st.vr["layers"][1] is None
    assert isinstance(st, AdafactorState)


#: C5: a hybrid's ``layers`` holds ``None`` only at its attention
#: positions, one every ``attn_every`` layers; below that period it holds
#: none, and the reference still keeps it a list of per-layer dicts.
HYBRID_TOL = 2e-5


@pytest.mark.parametrize("n_layers", [3, 8])
def test_adafactor_hybrid_layers_never_stack(n_layers, ref):
    """Reduced zamba2 at ``attn_every=6``: 3 layers (no attention
    position, C5) and 8 (one, the control), one Adafactor update from the
    same params and grads on both sides.  The port keeps as many ``vr``
    and ``vc`` leaves as the reference and updates every param alike."""
    import dataclasses
    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(),
                              attn_every=6, n_layers=n_layers)
    assert (None in init_params(cfg, device="meta")["layers"]) == (
        n_layers > 6)
    rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(5))
    g = draw_grads(ref, rp, 7)
    kw = dict(lr=1e-3)
    ropt = ref["optim"].get_optimizer("adafactor", **kw)
    topt = get_optimizer("adafactor", **kw)
    rp2, rs = ropt.update(rp, g, ropt.init(rp))
    tp = params_from_reference(
        ref["jax"].tree_util.tree_map(np.asarray, rp), cfg, "cpu")
    tp2, ts = topt.update(tp, params_from_reference(g, cfg, "cpu"),
                          topt.init(tp))
    for what, got, want in (("vr", ts.vr, rs.vr), ("vc", ts.vc, rs.vc)):
        got, want = stacked_flat(got), ref_flat(ref, want)
        assert len(got) == len(want), (what, len(got), len(want))
        close_flat(got, want, what, MOMENT_TOL)
    got, want = stacked_flat(tp2), ref_flat(ref, rp2)
    assert sorted(got) == sorted(want)
    for k in want:
        err = float(np.abs(got[k] - np.asarray(want[k], np.float32)).max(
            initial=0.0))
        assert err <= HYBRID_TOL, f"{k}: {err} > {HYBRID_TOL}"


def test_adafactor_refuses_layers_that_cannot_stack():
    opt = get_optimizer("adafactor")
    tree = {"layers": [{"w": torch.zeros(2, 3)}, {"w": torch.zeros(3, 3)}]}
    with pytest.raises(ValueError, match="one shape"):
        opt.init(tree)
    with pytest.raises(ValueError, match="keys"):
        opt.init({"layers": [{"w": torch.zeros(2)}, {"b": torch.zeros(2)}]})


def test_global_norm_matches_reference(pairs, ref):
    cfg, rp, tp = pairs["glm4-9b"]
    want = float(ref["optim"].adamw.global_norm(rp))
    assert abs(float(global_norm(tp)) - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# the reference's substrate tests, on the port
# ---------------------------------------------------------------------------

def _quadratic_params():
    return {"a": torch.tensor([3.0, -2.0]), "b": {"c": torch.tensor([[1.5]])}}


@pytest.mark.parametrize("name,lr,steps", [("adamw", 0.05, 200),
                                           ("adafactor", 0.05, 500)])
def test_optimizer_minimises_quadratic(name, lr, steps):
    opt = get_optimizer(name, lr=lr)
    params = _quadratic_params()
    state = opt.init(params)

    def loss_fn(p):
        return torch.sum(p["a"] ** 2) + torch.sum(p["b"]["c"] ** 2)

    for _ in range(steps):
        leaves = [params["a"].requires_grad_(),
                  params["b"]["c"].requires_grad_()]
        ga, gc = torch.autograd.grad(loss_fn(params), leaves)
        params, state = opt.update(
            {"a": leaves[0].detach(), "b": {"c": leaves[1].detach()}},
            {"a": ga, "b": {"c": gc}}, state)
    assert float(loss_fn(params)) < 1e-2


def test_adamw_bf16_params_fp32_moments():
    opt = get_optimizer("adamw", lr=0.01)
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert isinstance(state, AdamWState)
    assert state.m["w"].dtype == torch.float32
    grads = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    params, state = opt.update(params, grads, state)
    assert params["w"].dtype == torch.bfloat16
    assert state.v["w"].dtype == torch.float32


def test_adafactor_memory_is_factored():
    opt = get_optimizer("adafactor")
    params = {"w": torch.ones((128, 64))}
    state = opt.init(params)
    n_state = sum(t.numel() for t in (state.vr["w"], state.vc["w"]))
    assert n_state == 128 + 64  # not 128*64


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError):
        get_optimizer("sgd")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(256, 32, 4, 0),
                                                  (128, 16, 4, 1),
                                                  (8192, 128, 8, 0)])
def test_batches_bitwise_the_reference(vocab, seq, batch, seed, ref):
    tcfg = DataConfig(vocab, seq, batch, seed=seed)
    rcfg = ref["data"].DataConfig(vocab, seq, batch, seed=seed)
    n = batch * (seq + 1) * 8
    stream = synthetic_corpus(tcfg, n)
    want = ref["data"].synthetic_corpus(rcfg, n)
    assert stream.dtype == want.dtype and np.array_equal(stream, want)
    for step in (0, 3, 11):
        got, exp = make_batch(stream, tcfg, step), \
            ref["data"].make_batch(want, rcfg, step)
        assert sorted(got) == sorted(exp)
        for k in exp:
            assert got[k].dtype == exp[k].dtype and \
                np.array_equal(got[k], exp[k]), (step, k)
    for got, exp in zip(batch_iterator(tcfg, 4),
                        ref["data"].batch_iterator(rcfg, 4)):
        assert all(np.array_equal(got[k], exp[k]) for k in exp)


def test_corpus_has_learnable_structure():
    cfg = DataConfig(vocab_size=256, seq_len=32, global_batch=4, seed=0)
    stream = synthetic_corpus(cfg, 20_000)
    assert stream.min() >= 0 and stream.max() < 256
    pairs = {}
    for a, b in zip(stream[:-1], stream[1:]):
        pairs.setdefault(int(a), []).append(int(b))
    top_frac = np.mean([np.bincount(v).max() / len(v)
                        for v in pairs.values() if len(v) >= 20])
    assert top_frac > 0.3
    b = next(batch_iterator(cfg, 1))
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def same_tree(got, want):
    fg, fw = flatten(got), flatten(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and torch.equal(fg[k], fw[k]), k


def test_checkpoint_round_trip_bf16_and_state(tmp_path):
    """Params of reduced zamba2 in bf16 (``None`` at its attention
    positions) and an AdamW state come back bit for bit; the keys are
    the reference's."""
    import dataclasses
    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(),
                              dtype="bfloat16")
    params = init_params(cfg, 3, "cpu")
    state = get_optimizer("adamw").init(params)
    d = str(tmp_path)
    path = save_checkpoint(d, 7, {"params": params, "opt": state})
    assert path.endswith("ckpt_00000007.npz")
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt_00000007.npz"]
    with np.load(path) as f:
        assert "params/layers/0/ssm/in_proj/w" in f.files
        assert "opt/step" in f.files and "opt/m/embed/emb" in f.files
        assert f["params/embed/emb"].dtype == np.uint16
    template = {"params": init_params(cfg, 9, "cpu"),
                "opt": get_optimizer("adamw").init(params)}
    got = restore_checkpoint(d, 7, template)
    assert isinstance(got["opt"], AdamWState)
    assert got["params"]["layers"][1] is None
    same_tree(got, {"params": params, "opt": state})


def test_checkpoint_latest_step_and_shape_check(tmp_path):
    d = str(tmp_path)
    assert latest_step(d) is None
    assert latest_step(str(tmp_path / "missing")) is None
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    save_checkpoint(d, 5, tree)
    save_checkpoint(d, 12, tree)
    assert latest_step(d) == 12
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, 5, {"w": torch.zeros(3, 3)})


def test_checkpoints_cross_packages(tmp_path, ref):
    """An f32 and int32 tree written by the port restores in the
    reference, and one written by the reference in the port."""
    rng = np.random.default_rng(2)
    tree = {"layer": {"w": rng.standard_normal((2, 3)).astype(np.float32),
                      "n": np.arange(4, dtype=np.int32)},
            "stack": [rng.standard_normal(2).astype(np.float32),
                      np.full(2, 7.0, np.float32)]}
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(mine, 3, {"layer": {k: torch.from_numpy(v) for k, v in
                                        tree["layer"].items()},
                              "stack": [torch.from_numpy(v)
                                        for v in tree["stack"]]})
    zeros = ref["jax"].tree_util.tree_map(np.zeros_like, tree)
    got = ref["ckpt"].restore_checkpoint(mine, 3, zeros)
    for a, b in zip(ref["jax"].tree_util.tree_leaves(got),
                    ref["jax"].tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ref["ckpt"].save_checkpoint(theirs, 4, tree)
    assert latest_step(theirs) == 4
    template = {"layer": {"w": torch.zeros(2, 3),
                          "n": torch.zeros(4, dtype=torch.int32)},
                "stack": [torch.zeros(2), torch.zeros(2)]}
    got = restore_checkpoint(theirs, 4, template)
    assert torch.equal(got["layer"]["n"], torch.arange(4, dtype=torch.int32))
    assert np.array_equal(got["layer"]["w"].numpy(), tree["layer"]["w"])
    assert np.array_equal(got["stack"][1].numpy(), tree["stack"][1])
