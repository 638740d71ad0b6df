"""Vertical scaling (``Scenario(resize=...)``) through ``simulate`` in the
PyTorch port against the reference ``repro.sim``, bitwise.

On the CPU: ``tests/test_invariants.py``'s resize policies x {static,
failures, autoscale} x every mode, and chunked at sizes that split
blocks (node, outcome, ``Result.vertical``, every summary key); resize
with telemetry and chains on a chained trace in every run shape; the
``Resize`` knob, the inert result without it, and the ``static`` policy
serving the no-resize outcomes.  The pool, the registry, the block
runner, the invariants, the goldens and the card are in
``tests/test_torch_vertical_pool.py``.  The reference (and ``conftest``,
which imports it) is reached through fixtures, so the file also collects
where JAX is absent (the GPU host).
"""
import dataclasses

import numpy as np
import pytest

import repro_torch.sim as T
from repro_torch.core.types import Trace as PortTrace

MODES = ("gather", "vmap", "fused")
KINDS = ("static", "failures", "autoscale")
#: ``tests/test_invariants.py``'s resize axis, as port knobs.
RESIZES = (None, "static", T.Resize("fair_share", min_mb=0.0),
           T.Resize("fair_share", min_mb=48.0))
RZ_IDS = ("off", "static", "fair", "fair48")
N_EVENTS = 400


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def qtrace():
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(3), N_EVENTS)


def ref_resize(ref, rz):
    if rz is None or isinstance(rz, str):
        return rz
    return ref.Resize(rz.policy, rz.min_mb)


def scenario(mod, kind, resize, **kw):
    """``tests/test_invariants.py``'s scenarios, in either package."""
    kw = dict(routing="size_aware", max_slots=32, name=kind, resize=resize,
              **kw)
    if kind == "failures":
        kw["failures"] = ((900.0, 1800.0, 1),)
    elif kind == "autoscale":
        kw["autoscale"] = mod.Autoscale(epoch_events=128, gain=0.1)
    return mod.Scenario.cluster((768.0, 1024.0), **kw)


def to_ref(ref, scn):
    """The reference's ``Scenario`` with every field of the port's."""
    kw = {f.name: getattr(scn, f.name) for f in dataclasses.fields(scn)}
    if scn.autoscale is not None:
        kw["autoscale"] = ref.Autoscale(**dataclasses.asdict(scn.autoscale))
    if scn.failures is not None:
        kw["failures"] = ref.Failures(scn.failures.windows)
    if scn.telemetry is not None:
        kw["telemetry"] = ref.Telemetry(scn.telemetry.window_events)
    if scn.chains is not None:
        kw["chains"] = ref.Chains(**dataclasses.asdict(scn.chains))
    kw["resize"] = ref_resize(ref, scn.resize)
    return ref.Scenario(**kw)


def assert_bitwise(r, p, what=""):
    """Per-event and per-epoch outputs, the vertical totals, every
    window and per-chain array and every summary key, bitwise."""
    for f in ("node", "outcome", "per_node", "fracs", "active",
              "invalidated", "node_up"):
        x, y = getattr(r, f), getattr(p, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            x = np.asarray(x)
            assert x.dtype == y.dtype, (what, f, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
    assert (r.vertical is None) == (p.vertical is None), what
    for k in r.vertical or ():
        x, y = np.asarray(r.vertical[k]), p.vertical[k]
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (what, k)
    for owner in ("telemetry", "chains"):
        a, b = getattr(r, owner), getattr(p, owner)
        assert (a is None) == (b is None), (what, owner)
        for f in (dataclasses.fields(a) if a is not None else ()):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                    (what, owner, f.name)
    assert r.summary() == p.summary(), what


# ---------------------------------------------------------------------------
# simulate: the reference's resize matrix
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_matrix(ref, qtrace):
    """The reference's ``gather`` run per (kind, resize) (its modes are
    bitwise equal to one another, by its own tests)."""
    cache = {}

    def run(kind, i):
        if (kind, i) not in cache:
            cache[kind, i] = ref.simulate(
                scenario(ref, kind, ref_resize(ref, RESIZES[i])), qtrace)
        return cache[kind, i]
    return run


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rz", range(len(RESIZES)), ids=RZ_IDS)
def test_simulate_matches_reference(rz, kind, mode, ref_matrix, qtrace):
    want = ref_matrix(kind, rz)
    got = T.simulate(scenario(T, kind, RESIZES[rz]), PortTrace(*qtrace),
                     mode=mode, device="cpu")
    assert_bitwise(want, got, (kind, RZ_IDS[rz], mode))
    if RESIZES[rz] is None:
        assert got.vertical is None
    else:
        assert set(got.vertical) == {"acc_used_mb", "acc_alloc_mb",
                                     "bottlenecks"}
        assert got.vertical["acc_used_mb"].shape == (4,)
    if rz >= 2:
        assert got.summary()["bottleneck_events"] > 0


@pytest.mark.parametrize("kind", ["static", "failures"])
@pytest.mark.parametrize("rz,chunk,mode", [
    (1, 101, "fused"), (2, 160, "vmap"), (3, 33, "gather")],
    ids=["static-101", "fair-160", "fair48-33"])
def test_chunked_matches_reference(kind, rz, chunk, mode, ref_matrix,
                                   qtrace):
    """Chunks of 33, 101 and 160 events through the block runner (K = 32
    on the CPU: every chunk leaves an eager remainder) carry the resize
    fields from chunk to chunk: the monolithic reference's results."""
    got = T.simulate(scenario(T, kind, RESIZES[rz]), PortTrace(*qtrace),
                     mode=mode, chunk_events=chunk, device="cpu")
    assert_bitwise(ref_matrix(kind, rz), got, (kind, rz, chunk, mode))


@pytest.fixture(scope="module")
def chained():
    from repro_torch.workloads import ChainConfig, chained_trace
    return chained_trace(ChainConfig(duration_s=90.0, seed=2)).head(160)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_telemetry_and_chains_with_resize_match_reference(kind, mode, ref,
                                                          chained):
    """Resize with telemetry (windows of 50 events) and chains on a
    chained trace, static, with an outage and autoscaled (node scaling):
    every window and per-chain array, the vertical totals and the
    summary equal the reference's; in ``fused`` the static and failure
    kinds also in chunks of 70."""
    t = chained.t
    kw = dict(routing="slack_aware", max_slots=16, telemetry=50,
              chains=T.Chains(slack=3.0), resize=T.Resize("fair_share", 8.0))
    if kind != "static":
        kw["failures"] = ((float(t[30]), float(t[90]), 1),)
    if kind == "autoscale":
        kw["autoscale"] = T.Autoscale(epoch_events=40, gain=0.2,
                                      spawn_drop_frac=0.05,
                                      retire_drop_frac=0.01, init_active=2)
    scn = T.Scenario.cluster((300.0, 400.0, 500.0), **kw)
    want = ref.simulate(to_ref(ref, scn), _ref_trace(ref, chained))
    assert want.summary()["bottleneck_events"] > 0
    chunks = (None, 70) if mode == "fused" and kind != "autoscale" \
        else (None,)
    for chunk in chunks:
        got = T.simulate(scn, chained, mode=mode, chunk_events=chunk,
                         device="cpu")
        assert_bitwise(want, got, (kind, mode, chunk))


def _ref_trace(ref, tr):
    from repro.core.types import Trace as RefTrace
    return RefTrace(*tr)


# ---------------------------------------------------------------------------
# the knob, the result, the config
# ---------------------------------------------------------------------------

def test_resize_knob_sugar_and_validation():
    rz = T.Resize("fair_share", 32)
    assert rz.min_mb == 32.0 and isinstance(rz.min_mb, float)
    for knob in ("fair_share", {"policy": "fair_share", "min_mb": 32.0}, rz):
        sc = T.Scenario.kiss(1024.0, resize=knob)
        assert sc.resize == T.Resize("fair_share", 32.0 if knob !=
                                     "fair_share" else 0.0)
        assert sc.label == "kiss-1n-sticky-lru-resize"
        cfg = sc.to_cluster_config()
        assert cfg.resize_policy == T.RESIZE.resolve("fair_share")
    assert T.Scenario.kiss(1024.0).to_cluster_config().resize_policy is None
    with pytest.raises(ValueError, match="resize"):
        T.Scenario.kiss(1024.0, resize=3)
    with pytest.raises(ValueError, match="min_mb"):
        T.Resize("static", -1.0)
    with pytest.raises(KeyError, match="resize policy"):
        T.Resize("shrink_everything")
    with pytest.raises(ValueError, match="resize_min_mb"):
        dataclasses.replace(T.Scenario.kiss(1024.0).to_cluster_config(),
                            resize_min_mb=-1.0)


def test_result_without_resize_reports_inert_zeros(qtrace):
    res = T.simulate(scenario(T, "static", None), PortTrace(*qtrace).head(50),
                     device="cpu")
    assert res.vertical is None
    assert (res.utilization_ratio, res.bottleneck_events) == (0.0, 0)
    s = res.summary()
    assert (s["utilization_ratio"], s["bottleneck_events"]) == (0.0, 0)


def test_static_resize_serves_the_no_resize_outcomes(qtrace):
    """``benchmarks/vertical.py``'s ``vertical_static_noop``: the
    ``static`` policy observes and never shrinks, so every outcome key
    equals the run without resize."""
    tr = PortTrace(*qtrace)
    off = T.simulate(scenario(T, "static", None), tr, mode="fused",
                     device="cpu")
    on = T.simulate(scenario(T, "static", "static"), tr, mode="fused",
                    device="cpu")
    np.testing.assert_array_equal(off.outcome, on.outcome)
    keys = ("utilization_ratio", "bottleneck_events")
    assert {k: v for k, v in off.summary().items() if k not in keys} == \
        {k: v for k, v in on.summary().items() if k not in keys}
    assert 0.0 < on.utilization_ratio < 1.0 and on.bottleneck_events == 0
