"""The port's serving runtime against the JAX reference, on the CPU.

* ``WarmPool``: one access sequence through both packages gives the same
  outcomes, victims, free memory, clock and ``ClassMetrics`` (exactly:
  the pool is f32-mirrored numpy on both sides).
* Container sizes: equal to the reference's for the reduced configs, and
  at full width for starcoder2-3b, glm4-9b, zamba2-1.2b, rwkv6-7b and the
  MoE, VLM and audio families from shapes alone (``jax.eval_shape`` /
  ``device="meta"``), so the server's class and pool decisions at full
  width are the reference's.
* Servers: one request stream through ``repro.serving`` and the port
  gives the same statuses and metrics; a port container holding the
  reference container's weights gives its prefill and decode logits
  (f32, 1e-5 absolute and relative, as ``test_torch_models.py``), its
  warm-up batch as the reference's (3-D positions for a VLM, zero frame
  embeddings for whisper).

The reference is imported inside fixtures, so the file also collects
where JAX is absent; the ``cuda``-marked tests run the container on the
card.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import params_from_reference
from repro_torch.configs import get_config
from repro_torch.core.pool_ref import WarmPool
from repro_torch.core.types import ClassMetrics, Policy, PoolConfig
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ssm_scan import ssm_scan_cuda
from repro_torch.kernels.wkv6 import wkv6_cuda
from repro_torch.launch import serve as T_serve
from repro_torch.models import init_params
from repro_torch.serving import (Batcher, KissServer, ModelContainer,
                                 Request, UnifiedServer, cache_mb,
                                 pytree_mb)

CKW = dict(max_batch=2, max_len=64)
ARCHS = ("starcoder2-3b", "granite-34b", "glm4-9b", "qwen2.5-32b")
#: The models that carry the serving path of each ported family.
SIZED = ("starcoder2-3b", "glm4-9b", "zamba2-1.2b", "rwkv6-7b")
#: The models of the MoE, VLM and audio families.
FAMILIES = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b", "qwen2-vl-7b",
            "whisper-medium")
#: chip_smoke.py's KissServer budget (``SERVE_BUDGET`` there).
SMOKE_BUDGET = dict(total_mb=96_000, small_frac=0.27, threshold_mb=20_000)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.core.pool_ref as pool_ref
    import repro.core.types as types
    import repro.launch.serve as serve
    import repro.models as models
    import repro.serving as serving
    return dict(jax=jax, jnp=jnp, pool_ref=pool_ref, types=types,
                serve=serve, models=models, serving=serving)


def registry():
    return {a: get_config(a).reduced() for a in ARCHS}


def ref_registry(ref, archs=ARCHS):
    from repro.configs import get_config as ref_get_config
    return {a: ref_get_config(a).reduced() for a in archs}


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def access_sequence(seed, n=400):
    """Events (t, func_id, size, warm, cold) with whole-MB sizes per
    function, a few busy overlaps and capacity changes."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(10, 300, 24).astype(np.float32)
    t = np.cumsum(rng.exponential(0.5, n)).astype(np.float32)
    fid = rng.zipf(1.3, n) % 24
    warm = rng.uniform(0.1, 2.0, n).astype(np.float32)
    cold = warm + rng.uniform(0.5, 4.0, n).astype(np.float32)
    return [(float(t[i]), int(fid[i]), float(sizes[fid[i]]), float(warm[i]),
             float(cold[i])) for i in range(n)]


@pytest.mark.parametrize("policy", list(Policy))
@pytest.mark.parametrize("seed", [0, 1])
def test_warm_pool_matches_reference(policy, seed, ref):
    R = ref["pool_ref"]
    ref_pool = R.WarmPool(ref["types"].PoolConfig(1024.0, int(policy), 8))
    pool = WarmPool(PoolConfig(1024.0, policy, 8))
    rm, tm = ref["types"].ClassMetrics(), ClassMetrics()
    for i, (t, fid, size, warm, cold) in enumerate(access_sequence(seed)):
        if i % 97 == 96:          # a capacity change between epochs
            cap = 600.0 if (i // 97) % 2 else 1500.0
            want = ref_pool.resize(t, cap)
            got = pool.resize(t, cap)
        elif i == 250:
            assert pool.invalidate() == ref_pool.invalidate()
            continue
        else:
            assert pool.access(t, fid, size, warm, cold, tm) == \
                ref_pool.access(t, fid, size, warm, cold, rm), i
            want, got = ref_pool.last_victims, pool.last_victims
        assert [(c.func_id, c.size_mb, c.gd_priority) for c in got] == \
            [(c.func_id, c.size_mb, c.gd_priority) for c in want], i
        assert (pool.free_mb, pool.clock) == (ref_pool.free_mb,
                                              ref_pool.clock), i
        # a hard shrink may leave busy residents above capacity
        assert pool.occupancy_ok() == ref_pool.occupancy_ok(), i
    assert (tm.hits, tm.misses, tm.drops, tm.exec_time) == \
        (rm.hits, rm.misses, rm.drops, rm.exec_time)
    assert tm.misses > 0 and tm.hits > 0


def test_resize_policy_raises_naming_a11():
    """``PoolConfig(resize_policy=...)`` raised until vertical scaling was
    ported (ROADMAP A11).  Now a ``fair_share`` pool admits a container
    by shrinking an idle resident to its observed usage (36 of 60 MB for
    function 6) where a pool without resize evicts it, and a hit on the
    shrunken resident is a bottleneck event."""
    stream = ((0.0, 6, 60.0), (5.0, 8, 64.0), (10.0, 6, 60.0))
    rz = WarmPool(PoolConfig(100.0, Policy.LRU, 8,
                             resize_policy="fair_share"))
    plain = WarmPool(PoolConfig(100.0, Policy.LRU, 8))
    got = {}
    for name, pool in (("rz", rz), ("plain", plain)):
        m = ClassMetrics()
        got[name] = [pool.access(t, f, size, 1.0, 2.0, m)
                     for t, f, size in stream]
    assert got["rz"] == ["miss", "miss", "hit"]
    assert got["plain"] == ["miss", "miss", "miss"]
    six = next(c for c in rz.containers if c.func_id == 6)
    assert (six.alloc_mb, six.used_mb, six.size_mb) == (36.0, 36.0, 60.0)
    assert rz.free_mb == 0.0 and rz.occupancy_ok()
    assert (rz.bneck, rz.acc_used, rz.acc_alloc) == (1, 36.0 + 49.0 + 36.0,
                                                     60.0 + 64.0 + 36.0)


# ---------------------------------------------------------------------------
# container sizes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_containers(ref):
    return {a: ref["serving"].ModelContainer(cfg, **CKW)
            for a, cfg in ref_registry(ref, SIZED + FAMILIES).items()}


@pytest.mark.parametrize("arch", SIZED + FAMILIES)
def test_reduced_container_size_matches_reference(arch, ref_containers):
    c = ModelContainer(get_config(arch).reduced(), device="cpu", **CKW)
    assert c.size_mb == pytest.approx(ref_containers[arch].size_mb,
                                      rel=1e-12)
    assert c.cold_start_s > 0


@pytest.mark.parametrize("arch", SIZED + FAMILIES)
def test_full_width_container_size_matches_reference(arch, ref):
    """The container of ``chip_smoke.py`` (max_batch 2, max_len 4096)."""
    jax, jnp = ref["jax"], ref["jnp"]
    cfg = get_config(arch)
    params = jax.eval_shape(lambda: ref["models"].init_params(
        cfg, jax.random.PRNGKey(0)))
    caches = jax.eval_shape(lambda: ref["models"].init_caches(
        cfg, 2, 4096, dtype=jnp.float32))
    want = ref["serving"].pytree_mb(params) + \
        ref["serving"].pytree_mb(caches)
    got = pytree_mb(init_params(cfg, device="meta")) + cache_mb(cfg, 2, 4096)
    assert got == pytest.approx(want, rel=1e-12)


def test_full_width_classes_of_the_smoke_run():
    """chip_smoke.py's KissServer: the f32 estimates put starcoder2-3b,
    zamba2-1.2b and granite-moe-1b-a400m in the small pool (24,449 MB of
    25,920) and rwkv6-7b and glm4-9b in the large one (67,665 MB of
    70,080), and each pool holds all of its models at once; 16 requests
    of seed 0 give every model at least one."""
    reg = {a: get_config(a) for a in ("starcoder2-3b", "rwkv6-7b",
                                      "zamba2-1.2b", "glm4-9b",
                                      "granite-moe-1b-a400m")}
    srv = KissServer(reg, **SMOKE_BUDGET)
    want = {"starcoder2-3b": 12_722.491392, "rwkv6-7b": 30_065.819648,
            "zamba2-1.2b": 6_186.377216, "glm4-9b": 37_599.051776,
            "granite-moe-1b-a400m": 5_539.848192}
    for m, mb in want.items():
        assert srv.size_mb(m) == pytest.approx(mb)
    assert (srv.small_pool.cfg.capacity_mb,
            srv.large_pool.cfg.capacity_mb) == (25_920.0, 70_080.0)
    reqs = T_serve.synthesize_requests(reg, 16, seed=0)
    assert {m: sum(r.model_id == m for r in reqs) for m in reg} == {
        "starcoder2-3b": 4, "rwkv6-7b": 6, "zamba2-1.2b": 3, "glm4-9b": 1,
        "granite-moe-1b-a400m": 2}
    small = ("starcoder2-3b", "zamba2-1.2b", "granite-moe-1b-a400m")
    large = ("rwkv6-7b", "glm4-9b")
    for models, pool in ((small, srv.small_pool), (large, srv.large_pool)):
        assert all(srv._pool_for(m) is pool for m in models)
        assert sum(want[m] for m in models) <= pool.cfg.capacity_mb


# ---------------------------------------------------------------------------
# servers and containers
# ---------------------------------------------------------------------------

def statuses(reqs):
    return [r.result.status for r in reqs]


@pytest.mark.parametrize("unified", [False, True])
def test_server_matches_reference(unified, ref):
    kw = dict(total_mb=20.0, threshold_mb=6.5)
    if unified:
        kw = dict(total_mb=13.0, threshold_mb=6.5)
    else:
        kw["small_frac"] = 0.5
    ref_cls = ref["serving"].UnifiedServer if unified \
        else ref["serving"].KissServer
    cls = UnifiedServer if unified else KissServer
    ref_srv = ref_cls(ref_registry(ref), container_kwargs=CKW, **kw)
    srv = cls(registry(), container_kwargs=dict(CKW, device="cpu"), **kw)
    ref_reqs = ref["serve"].synthesize_requests(ref_registry(ref), 10,
                                                seed=3)
    reqs = T_serve.synthesize_requests(registry(), 10, seed=3)
    assert [(r.model_id, r.tokens.tolist()) for r in reqs] == \
        [(r.model_id, r.tokens.tolist()) for r in ref_reqs]
    want = ref["serve"].run(ref_srv, ref_registry(ref), ref_reqs)
    got = T_serve.run(srv, registry(), reqs)
    assert statuses(reqs) == statuses(ref_reqs)
    for k in ("total", "cold_start_pct", "drop_pct", "hit_rate"):
        assert got[k] == want[k], k
    for c in (0, 1):
        a, b = srv.stats.cls(c), ref_srv.stats.cls(c)
        assert (a.hits, a.misses, a.drops, a.exec_time) == \
            (b.hits, b.misses, b.drops, b.exec_time)
    assert set(srv.containers) == set(ref_srv.containers)
    assert {"miss", "hit"} <= set(statuses(reqs))


def test_eviction_releases_the_container():
    reg = {a: get_config(a).reduced() for a in ("starcoder2-3b", "glm4-9b")}
    srv = UnifiedServer(reg, total_mb=12.0, threshold_mb=6.5,
                        container_kwargs=dict(CKW, device="cpu"))
    toks = np.zeros((1, 4), np.int32)
    assert srv.submit("starcoder2-3b", toks, 2, now=0.0).status == "miss"
    gone = weakref.ref(srv.containers["starcoder2-3b"].params["embed"]["emb"])
    assert srv.submit("glm4-9b", toks, 2, now=1.0).status == "miss"
    gc.collect()
    assert list(srv.containers) == ["glm4-9b"] and gone() is None


def test_container_logits_match_reference(ref, ref_containers):
    """The port's container with the reference container's weights:
    prefill then decode logits, step by step, and the greedy tokens."""
    container_logits_match(ref, ref_containers, "starcoder2-3b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_container_logits_match_reference(arch, ref,
                                                 ref_containers):
    """As above for the MoE, VLM and audio families: the container's
    batches are the reference's ``_dummy_batch`` (3-D (t, t, t) positions
    for qwen2-vl, zero frame embeddings for whisper)."""
    container_logits_match(ref, ref_containers, arch)


def container_logits_match(ref, ref_containers, arch):
    rc = ref_containers[arch]
    cfg = get_config(arch).reduced()
    c = ModelContainer(cfg, device="cpu", **CKW)
    c.params = params_from_reference(
        ref["jax"].tree_util.tree_map(np.asarray, rc.params), cfg, "cpu")
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 12)).astype(np.int32)
    tokens, logits = c.generate_with_logits(prompt, 5)
    assert tokens.shape == (1, 5) and logits.shape == (1, 5, cfg.vocab_size)
    # the reference's generate, keeping its logits
    s = rc._compiled_prefill_len
    toks = np.zeros((2, s), np.int32)
    toks[:1, :12] = prompt
    batch = rc._dummy_batch(2, s)
    batch["tokens"] = ref["jnp"].asarray(toks)
    want, caches = rc._prefill(rc.params, batch)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               np.asarray(want[:1, -1]), rtol=1e-5,
                               atol=1e-5)
    for i in range(1, 5):
        d = rc._dummy_batch(2, 1)
        d["tokens"] = ref["jnp"].argmax(want[:, -1], -1)[:, None] \
            .astype(np.int32)
        d["positions"] = d["positions"] + s + i - 1
        d["seq_positions"] = d["seq_positions"] + s + i - 1
        want, caches = rc._decode(rc.params, d, caches)
        np.testing.assert_allclose(logits[:, i].numpy(),
                                   np.asarray(want[:1, -1]), rtol=1e-5,
                                   atol=1e-5)
    assert np.array_equal(tokens, rc.generate(prompt, 5))


def test_serve_cli_and_registry(capsys):
    """The CLI's registry of four archs (dense, SSM, hybrid) runs, and so
    does ``default_registry(6)``, the function's own default, which adds
    qwen2.5-32b and granite-moe-1b-a400m (MoE); its models all build."""
    assert T_serve.main(["--device", "cpu", "--requests", "8"]) == 0
    assert "KiSS(80-20)" in capsys.readouterr().out
    assert list(T_serve.default_registry(4)) == [
        "starcoder2-3b", "rwkv6-7b", "zamba2-1.2b", "glm4-9b"]
    six = T_serve.default_registry()
    assert list(six) == list(T_serve.default_registry(4)) + [
        "qwen2.5-32b", "granite-moe-1b-a400m"]
    assert all(init_params(cfg, device="cpu") for cfg in six.values())
    assert T_serve.main(["--device", "cpu", "--n-archs", "6",
                         "--requests", "12"]) == 0
    assert "drop_pct" in capsys.readouterr().out


def test_batcher_groups_and_pads():
    srv = KissServer(registry(), total_mb=200.0, threshold_mb=8.0,
                     container_kwargs=dict(CKW, device="cpu"))
    b = Batcher(srv, max_batch=2)
    rng = np.random.default_rng(0)
    for i in range(4):
        b.enqueue(Request("starcoder2-3b",
                          rng.integers(0, 100, 4 + i).astype(np.int32),
                          n_new=2, arrival=float(i)))
    done = b.drain()
    assert [r.result.status for r in done] == ["miss", "miss", "hit", "hit"]
    assert all(r.result.tokens.shape == (1, 2) for r in done)
    assert not b.queue


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelContainer(get_config("glm4-9b").reduced(), **CKW)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", SIZED + ("granite-moe-1b-a400m",))
def test_container_on_card_launches_the_kernels(arch):
    """Warm-up (one prefill, one decode) and a generate of 4 tokens: per
    prefill B3 once an attention position and B4 once a Mamba layer; per
    decode step B2 once an attention position; B5 once an RWKV layer per
    prefill and per decode step.  Logits equal the same weights' CPU run
    within 1e-4 (f32 kernels against the plain versions, cuBLAS against
    the CPU's matmuls)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    cfg = get_config(arch).reduced()
    kernels = (flash_attention_cuda, decode_attention_cuda, ssm_scan_cuda,
               wkv6_cuda)
    before = [k.launches for k in kernels]
    c = ModelContainer(cfg, device="cuda", **CKW)
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    tokens, logits = c.generate_with_logits(prompt, 4)
    kinds = cfg.layer_kinds()
    attn, mamba, rwkv = (kinds.count(k) for k in ("attn", "mamba", "rwkv"))
    prefills, decodes = 2, 1 + 3
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        attn * prefills, attn * decodes, mamba * prefills,
        rwkv * (prefills + decodes)]
    cpu = ModelContainer(cfg, device="cpu", **CKW)
    cpu.params = torch.utils._pytree.tree_map(
        lambda t: None if t is None else t.cpu(), c.params)
    want_tokens, want = cpu.generate_with_logits(prompt, 4)
    np.testing.assert_allclose(logits.cpu().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert np.array_equal(tokens, want_tokens)


def test_every_port_module_imports_without_jax():
    """Every module of the port imports, and the serving path runs on the
    CPU, in a process where ``jax`` cannot be imported."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        from repro_torch.launch.serve import main
        main(["--device", "cpu", "--n-archs", "1", "--requests", "2"])
        bad = sorted(m for m, v in sys.modules.items() if v is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert len(names) > 40, names
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr
