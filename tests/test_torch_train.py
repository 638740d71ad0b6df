"""The port's training path against the JAX reference, on the CPU.

``loss_fn``'s value and the gradient of every param leaf against
``jax.value_and_grad(repro.models.loss_fn)``, for a reduced config of
each family (dense, MoE with its aux loss, VLM with spliced patches and
3-D positions, whisper, hybrid, SSM), in f32, with the reference's
weights carried across by ``params_from_reference`` and the same batch
(labels with masked positions) from a numpy seed.  Tolerances: the loss
within 1e-5 relative, each leaf's grad within 1e-5 of its largest
magnitude (``GRAD_TOL``): both sides differentiate the same f32 ops and
differ in the order of their sums (the port's explicit kernel backwards
are not on this path: on the CPU autograd differentiates the plain
versions); a lost mask, a missing aux term or a grad that does not reach
a layer lies far outside.  Then ``remat`` on and off, the port's
``train_step`` against its own ``loss_fn`` and ``optimizer.update``, a
20-step loss trajectory against the reference's ``train_step`` (1e-3
relative: the two sides' params drift apart by rounding, step by step),
``launch.train.main`` on the CPU, and the new modules imported and two
steps taken with JAX blocked.  The reference is imported inside
fixtures, so the file also collects where JAX is absent.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch._tree import tree_leaves, tree_unflatten
from repro_torch.checkpoint import latest_step, params_from_reference
from repro_torch.checkpoint.convert import flatten
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batch_iterator
from repro_torch.launch import steps as T_steps
from repro_torch.launch import train as T_train
from repro_torch.models import loss_fn
from repro_torch.optim import get_optimizer

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
#: family: reduced arch of that family.
FAMILIES = {"dense": "starcoder2-3b", "moe": "granite-moe-1b-a400m",
            "vlm": "qwen2-vl-7b", "audio": "whisper-medium",
            "hybrid": "zamba2-1.2b", "ssm": "rwkv6-7b"}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.launch.steps as steps
    import repro.models as models
    import repro.optim as optim
    from repro.checkpoint import ckpt
    from repro.models import frontends
    return dict(jax=jax, jnp=jnp, models=models, frontends=frontends,
                steps=steps, optim=optim, ckpt=ckpt)


@pytest.fixture(scope="module")
def pairs(ref):
    """Per family: (reduced cfg, reference params, the port's params)."""
    out = {}
    for fam, arch in FAMILIES.items():
        cfg = get_config(arch).reduced()
        rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(21))
        tp = params_from_reference(
            ref["jax"].tree_util.tree_map(np.asarray, rp), cfg, "cpu")
        out[fam] = (cfg, rp, tp)
    return out


def np_batch(ref, cfg, s=16, seed=0) -> dict:
    """One batch of numpy arrays for ``cfg``'s family, with two masked
    labels."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = -1
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    out = {"tokens": toks, "labels": labels, "positions": pos}
    if cfg.arch_type == "vlm":
        emb, pp, pos3 = (np.asarray(a) for a in
                         ref["frontends"].stub_vision_patches(
                             ref["jax"].random.PRNGKey(seed), cfg, 2, 5, s))
        out.update(patch_embeds=emb * 50, patch_positions=pp,
                   positions=pos3)
    if cfg.is_encoder_decoder:
        out["frame_embeds"] = np.asarray(ref["frontends"].stub_audio_frames(
            ref["jax"].random.PRNGKey(seed), cfg, 2))
    return out


def both(ref, batch):
    return ({k: ref["jnp"].asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.copy()) for k, v in batch.items()})


def port_value_and_grad(cfg, params, batch, remat):
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    total, metrics = loss_fn(cfg, tree_unflatten(params, live), batch,
                             remat=remat)
    grads = torch.autograd.grad(total, live)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def stacked_flat(tree) -> dict:
    """The port's tree in the reference's layout (each list with no
    ``None`` stacked on a leading axis), flat, as numpy."""
    def lay(t):
        if isinstance(t, dict):
            return {k: lay(v) for k, v in t.items()}
        if isinstance(t, list) and t and all(e is not None for e in t):
            layers = [flatten(lay(e)) for e in t]
            return {k: np.stack([lp[k] for lp in layers]) for k in layers[0]}
        if isinstance(t, list):
            return [lay(e) for e in t]
        return t if t is None else t.detach().float().numpy()
    return flatten(lay(tree))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_reference(family, pairs, ref):
    cfg, rp, tp = pairs[family]
    jb, tb = both(ref, np_batch(ref, cfg))
    (want, want_m), want_g = ref["jax"].value_and_grad(
        lambda p: ref["models"].loss_fn(cfg, p, jb, remat=False),
        has_aux=True)(rp)
    total, metrics, grads = port_value_and_grad(cfg, tp, tb, remat=False)
    assert total.dtype == torch.float32 and total.shape == ()
    assert sorted(metrics) == ["loss", "moe_aux", "router_entropy"]
    assert abs(float(total) - float(want)) <= LOSS_TOL * abs(float(want))
    for k in want_m:
        assert abs(float(metrics[k]) - float(want_m[k])) <= \
            LOSS_TOL * max(abs(float(want_m[k])), 1e-6), k
    if family == "moe":
        assert float(metrics["moe_aux"]) > 0
        assert float(total) > float(metrics["loss"])
    got = stacked_flat(grads)
    exp = {k: np.asarray(v) for k, v in
           ref["ckpt"]._flatten(want_g).items()}
    assert sorted(got) == sorted(exp)
    for k, w in exp.items():
        scale = float(np.abs(w).max())
        assert scale > 0, f"{family} {k}: no gradient"
        err = float(np.abs(got[k] - w).max())
        assert err <= GRAD_TOL * scale, f"{family} {k}: {err} > " \
            f"{GRAD_TOL} x {scale}"


@pytest.mark.parametrize("family", ["hybrid", "moe", "ssm"])
def test_remat_gives_the_same_loss_and_grads(family, pairs, ref):
    cfg, _, tp = pairs[family]
    _, tb = both(ref, np_batch(ref, cfg, seed=1))
    a = port_value_and_grad(cfg, tp, tb, remat=True)
    b = port_value_and_grad(cfg, tp, tb, remat=False)
    assert torch.equal(a[0], b[0])
    for k, g in flatten(a[2]).items():
        assert torch.equal(g, flatten(b[2])[k]), k


def test_train_step_is_loss_fn_then_update(pairs, ref):
    cfg, _, tp = pairs["dense"]
    _, tb = both(ref, np_batch(ref, cfg, seed=2))
    opt = get_optimizer("adamw", lr=1e-3)
    state = opt.init(tp)
    got_p, got_s, metrics = T_steps.train_step(cfg, opt, tp, state, tb)
    total, want_m, grads = port_value_and_grad(cfg, tp, tb, remat=True)
    want_p, want_s = opt.update(tp, grads, state)
    assert all(torch.equal(metrics[k], want_m[k]) for k in want_m)
    for got, want in ((got_p, want_p), (got_s.m, want_s.m),
                      (got_s.v, want_s.v)):
        fw = flatten(want)
        assert all(torch.equal(v, fw[k]) for k, v in flatten(got).items())
    assert int(got_s.step) == 1
    assert all(not p.requires_grad for p in tree_leaves(got_p))


def test_twenty_steps_follow_the_reference(ref):
    """The dense config's loss over 20 AdamW steps on the pipeline's
    batches, against the reference's ``train_step`` (jitted) from the same
    weights."""
    cfg = get_config("glm4-9b").reduced()
    rp = ref["models"].init_params(cfg, ref["jax"].random.PRNGKey(5))
    tp = params_from_reference(
        ref["jax"].tree_util.tree_map(np.asarray, rp), cfg, "cpu")
    ropt = ref["optim"].get_optimizer("adamw", lr=3e-3)
    topt = get_optimizer("adamw", lr=3e-3)
    rs, ts = ropt.init(rp), topt.init(tp)
    step = ref["jax"].jit(lambda p, s, b: ref["steps"].train_step(
        cfg, ropt, p, s, b, remat=False))
    want, got = [], []
    for b in batch_iterator(DataConfig(cfg.vocab_size, 32, 4, seed=0), 20):
        jb, tb = both(ref, b)
        rp, rs, rm = step(rp, rs, jb)
        tp, ts, tm = T_steps.train_step(cfg, topt, tp, ts, tb, remat=False)
        want.append(float(rm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert want[-1] < want[0] - 0.5       # it learns


def test_default_optimizer_and_prefill_decode_steps():
    dense = get_config("glm4-9b")
    assert T_steps.default_optimizer(dense).name == "adamw"
    assert T_steps.default_optimizer(
        get_config("kimi-k2-1t-a32b")).name == "adafactor"
    cfg = dense.reduced()
    from repro_torch.models import init_params, prefill
    params = init_params(cfg, 0, "cpu")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)[None]
    batch = {"tokens": toks, "positions": pos, "seq_positions": pos}
    logits, caches = T_steps.prefill_step(cfg, params, batch, cache_len=8,
                                          window=None)
    want, _ = prefill(cfg, params, batch, cache_len=8)
    assert torch.equal(logits, want)
    one = {"tokens": toks[:, :1], "positions": pos[:, :1] + 4,
           "seq_positions": pos[:, :1] + 4}
    got, _ = T_steps.decode_step(cfg, params, one, caches, window=None)
    assert got.shape == (1, 1, cfg.vocab_size)


def test_train_main_on_the_cpu(tmp_path, capsys):
    rc = T_train.main(["--device", "cpu", "--arch", "glm4-9b", "--reduced",
                       "--steps", "12", "--batch", "2", "--seq", "32",
                       "--lr", "3e-3", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and out.strip().endswith("(improved)"), out
    assert latest_step(str(tmp_path)) == 12
    assert not torch.distributed.is_initialized()  # run's group is gone


def test_train_100m_config():
    cfg = T_train.train_100m_config()
    assert (cfg.n_layers, cfg.d_model, cfg.dtype) == (12, 768, "float32")
    assert 80e6 < cfg.param_count() < 150e6


def test_train_runs_without_jax_or_repro():
    """With ``jax`` unimportable, the training modules import and take
    two CPU steps, and no ``repro`` module is loaded."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        import repro_torch.optim, repro_torch.data, repro_torch.checkpoint
        import repro_torch.launch.steps
        from repro_torch.configs import get_config
        from repro_torch.launch.train import run
        hist = run(get_config("zamba2-1.2b").reduced(), steps=2,
                   global_batch=2, seq_len=8, log_every=1, device="cpu")
        assert len(hist) == 2 and all(h["loss"] > 0 for h in hist)
        bad = sorted(m for m, v in sys.modules.items() if v is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr
