"""The port's warm pool (``repro_torch.core.pool``) against the reference
``repro.core.pool_jax``, bitwise, per event.

States cross from the reference with ``pool_state_from_numpy`` (the
simulator's equivalent of loading weights), so both packages step the
same mid-run pool.  Mirrors ``tests/test_pool_kernel.py`` (:81, :118,
:138) on the port, plus the dtype-stability pin: a stray float64 would
silently break bitwise parity, since torch promotes 0-d f32 with 0-d f64
to f64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pool_jax as J
from repro.core.types import Policy as JPolicy
from repro.core.types import PoolConfig as JPoolConfig
from repro_torch.core import pool as T
from repro_torch.core import xp
from repro_torch.core.types import MISS, Policy, PoolConfig

POLICIES = ("LRU", "GREEDY_DUAL", "FREQ")


def to_port(state) -> T.PoolState:
    """A reference PoolState (single or stacked) as the port's, on CPU."""
    return T.pool_state_from_numpy(
        {k: np.asarray(v) for k, v in state._asdict().items()
         if v is not None}, "cpu")


def assert_state_equal(ref, got: T.PoolState, what=""):
    for name in T.STATE_DTYPES:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name)
        assert g.dtype == T.STATE_DTYPES[name], (what, name, g.dtype)
        assert np.array_equal(r, g.numpy()), (what, name)


def events(rng, n, n_funcs=6, t0=0.0):
    """Quantized random events: 1/4 s steps, whole-MB sizes."""
    out = []
    for i in range(n):
        vals = (t0 + i * 0.25, int(rng.integers(0, n_funcs)),
                float(rng.integers(16, 200)), 0,
                float(rng.integers(1, 64)) / 64.0,
                float(rng.integers(64, 640)) / 64.0)
        out.append(vals)
    return out


def jax_event(v):
    return J.Event(jnp.float32(v[0]), jnp.int32(v[1]), jnp.float32(v[2]),
                   jnp.int32(v[3]), jnp.float32(v[4]), jnp.float32(v[5]))


def port_event(v):
    f32, i32 = torch.float32, torch.int32
    return T.Event(torch.tensor(v[0], dtype=f32), torch.tensor(v[1], dtype=i32),
                   torch.tensor(v[2], dtype=f32), torch.tensor(v[3], dtype=i32),
                   torch.tensor(v[4], dtype=f32), torch.tensor(v[5], dtype=f32))


@pytest.mark.parametrize("policy", POLICIES)
def test_pool_step_matches_reference_per_event(policy):
    """``pool_step`` on one pool: the reference runs 40 events, its state
    crosses to the port mid-run, and both step 60 more events with every
    state field and outcome compared after each."""
    rng = np.random.default_rng(POLICIES.index(policy))
    ref = J.init_pool(JPoolConfig(700.0, JPolicy[policy], 12))
    evs = events(rng, 100)
    step = jax.jit(J.pool_step)
    for v in evs[:40]:
        ref, _ = step(ref, jax_event(v))
    got = to_port(ref)
    for i, v in enumerate(evs[40:]):
        ref, o_r = step(ref, jax_event(v))
        got, o_g = T.pool_step(got, port_event(v))
        assert o_g.dtype == torch.int32
        assert int(o_r) == int(o_g), (policy, i)
        assert_state_equal(ref, got, (policy, i))


def test_pool_step_batch_matches_vmap_bitwise():
    """``pool_step_batch`` through both backends == the reference's
    ``jax.vmap(pool_step)`` on every field, every replacement policy
    stacked as data, from a state carried across mid-run."""
    rng = np.random.default_rng(1)
    pools = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[J.init_pool(JPoolConfig(512.0, JPolicy[n], 12)) for n in POLICIES])
    vstep = jax.jit(jax.vmap(J.pool_step, in_axes=(0, None)))
    evs = events(rng, 60)
    for v in evs[:20]:
        pools, _ = vstep(pools, jax_event(v))
    lax_b = fus_b = to_port(pools)
    lax_fn, fus_fn = T.get_step_backend("lax"), T.get_step_backend("fused")
    for i, v in enumerate(evs[20:]):
        pools, o_r = vstep(pools, jax_event(v))
        lax_b, o_l = T.pool_step_batch(lax_b, port_event(v), lax_fn)
        fus_b, o_f = T.pool_step_batch(fus_b, port_event(v), fus_fn)
        assert np.array_equal(np.asarray(o_r), o_l.numpy()), i
        assert np.array_equal(np.asarray(o_r), o_f.numpy()), i
        assert_state_equal(pools, lax_b, ("lax", i))
        assert_state_equal(pools, fus_b, ("fused", i))


def test_evict_prefix_matches_reference_on_a_warm_pool():
    """Mirrors ``test_kernel_matches_evict_prefix_per_pool``: a warmed
    reference pool with equal ``last_use`` (pure-seq tie-break for LRU)
    crosses to the port; the port's ``_evict_prefix`` and both backends
    pick the reference's evict set for every deficit."""
    p = J.init_pool(JPoolConfig(2048.0, JPolicy.LRU, 16))
    for i in range(12):
        p, _ = J.pool_step(p, J.Event(
            jnp.float32(i / 64), jnp.int32(i), jnp.float32(100.0),
            jnp.int32(0), jnp.float32(0.5), jnp.float32(2.0)))
    p = p._replace(last_use=jnp.zeros_like(p.last_use))
    now = jnp.float32(100.0)
    idle = p.valid & (p.busy_until <= now)
    q = to_port(p)
    q_idle = torch.tensor(np.asarray(idle))
    pri = torch.where(q_idle, q.last_use, float("inf"))
    for deficit in (0.0, 150.0, 550.0, 1e6):
        ev_ref, freed_ref = J._evict_prefix(p, idle, jnp.float32(deficit))
        d = torch.tensor(deficit, dtype=torch.float32)
        ev, freed = T._evict_prefix(pri, q.seq, q.size, q_idle, d)
        assert np.array_equal(np.asarray(ev_ref), ev.numpy()), deficit
        assert float(freed_ref) == float(freed), deficit
        for name in ("lax", "fused"):
            out = T.get_step_backend(name)(
                pri[None], q.seq[None], q.size[None], q_idle[None],
                q.valid[None], d[None])
            assert np.array_equal(np.asarray(ev_ref), out[0][0].numpy())
            va = np.asarray(p.valid & ~ev_ref)
            assert int(out[2][0]) == int(np.argmax(~va)), (name, deficit)
            assert bool(out[4][0]) == bool(np.any(~va)), (name, deficit)


def test_gd_clock_no_eviction():
    """A GreedyDual miss that fits without evicting leaves the clock."""
    p = T.init_pool(PoolConfig(4096.0, Policy.GREEDY_DUAL, 8), "cpu")
    p = p._replace(clock=torch.tensor(7.25))
    ev = port_event((1.0, 3, 128.0, 0, 0.5, 2.0))
    new, outcome = T.pool_step(p, ev)
    assert int(outcome) == MISS
    assert float(new.clock) == 7.25
    stacked = T.stack_pools([p])
    for backend in ("lax", "fused"):
        nb, ob = T.pool_step_batch(stacked, ev, T.get_step_backend(backend))
        assert int(ob[0]) == MISS, backend
        assert float(nb.clock[0]) == 7.25, backend


@pytest.mark.parametrize("backend", ["lax", "fused"])
def test_state_dtypes_stable_across_steps(backend):
    """Every PoolState field keeps its dtype through hits, misses and
    drops, batched and single."""
    rng = np.random.default_rng(7)
    pools = T.stack_pools([
        T.init_pool(PoolConfig(300.0, Policy(k), 6), "cpu") for k in range(3)])
    one = T.init_pool(PoolConfig(300.0, Policy.GREEDY_DUAL, 6), "cpu")
    fn = T.get_step_backend(backend)
    seen = set()
    for v in events(rng, 40):
        pools, o = T.pool_step_batch(pools, port_event(v), fn)
        one, o1 = T.pool_step(one, port_event(v))
        seen.update(o.tolist())
        for name, dt in T.STATE_DTYPES.items():
            assert getattr(pools, name).dtype == dt, name
            assert getattr(one, name).dtype == dt, name
        assert o.dtype == o1.dtype == torch.int32
    assert seen == {0, 1, 2}   # hits, misses and drops all happened


def test_pool_state_from_numpy_validates():
    ref = J.init_pool(JPoolConfig(512.0, JPolicy.LRU, 4))
    leaves = {k: np.asarray(v) for k, v in ref._asdict().items()
              if v is not None}
    assert_state_equal(ref, T.pool_state_from_numpy(leaves, "cpu"))
    with pytest.raises(ValueError, match="not PoolState fields"):
        T.pool_state_from_numpy({**leaves, "bogus": np.zeros(1)}, "cpu")
    with pytest.raises(ValueError, match="missing"):
        T.pool_state_from_numpy(
            {k: v for k, v in leaves.items() if k != "seq"}, "cpu")
    # a resize-enabled state brings all seven resize fields (ROADMAP A11)
    with pytest.raises(ValueError, match="missing"):
        T.pool_state_from_numpy({**leaves, "alloc": np.zeros(4)}, "cpu")
    rz = J.init_pool(JPoolConfig(512.0, JPolicy.LRU, 4, resize_policy=1,
                                 resize_min_mb=8.0))
    got = T.pool_state_from_numpy(
        {k: np.asarray(v) for k, v in rz._asdict().items()}, "cpu")
    assert_state_equal(rz, got)
    for name, dt in T.RESIZE_DTYPES.items():
        assert getattr(got, name).dtype == dt
        assert np.array_equal(np.asarray(getattr(rz, name)),
                              getattr(got, name).numpy()), name
    # float64 leaves are cast to the reference's float32
    f64 = {**leaves, "size": leaves["size"].astype(np.float64)}
    assert T.pool_state_from_numpy(f64, "cpu").size.dtype == torch.float32


def test_step_backend_registry():
    assert set(T.step_backends()) >= {"lax", "fused"}
    with pytest.raises(ValueError, match="unknown step backend"):
        T.get_step_backend("nope")
    with pytest.raises(ValueError, match="already registered"):
        T.register_step_backend("lax")(lambda *a: a)


def test_xp_shim_spellings():
    """The torch ``xp`` namespace matches numpy where the policy bodies
    need it: bool argmax (first index, 0 when none), ``mod`` sign,
    scalar constructors rounded through the numpy type, 0-d indexing."""
    m = xp.asx(torch.tensor([False, True, True]))
    assert int(xp.argmax(m)) == 1
    assert int(xp.argmax(xp.asx(torch.zeros(3, dtype=torch.bool)))) == 0
    assert int(xp.argmin(xp.asx(torch.full((3,), float("inf"))))) == 0
    a, b = torch.tensor([-7, 7], dtype=torch.int32), torch.tensor(3)
    assert xp.mod(a, b).tolist() == np.mod(np.array([-7, 7]), 3).tolist()
    assert xp.float32(1e-6) == float(np.float32(1e-6))
    assert m.astype(xp.int32).dtype == torch.int32
    r = m[torch.tensor(1)]
    assert isinstance(r, xp.XTensor) and r.ndim == 0 and bool(r)
    assert int(xp.maximum(torch.tensor(0), 1)) == 1
