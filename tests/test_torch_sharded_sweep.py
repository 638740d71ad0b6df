"""Sharded sweeps (``repro_torch.sim.sweep(..., devices=k)``) in the
PyTorch port against the reference ``repro.sim.sweep`` and the port's own
unsharded sweep, bitwise.

Sharding cuts a group's lanes, padded with copies of lane 0 to a
multiple of ``k``, into ``k`` equal shards and runs each on its device
(``cuda:j``; on the CPU every shard on the CPU).  A CPU run has one
device, so the tests patch ``engine._device_count`` to let ``k`` shards
run here, one after another; the reference's lanes are independent, so
its unsharded sweep is what its ``devices=k`` gives, by its own
``tests/test_sharded_sweep.py``.  On a 300-event quantized trace and a
chained one: static groups in every step mode, failures, autoscale
(``fracs``), telemetry windows, chains, chunked runs with failures and
with chains and telemetry (whose shards share one CPU block runner, so
a view of its reused buffers would show), vertical scaling, lane counts
1, 2, 3 and 7 at ``k`` = 2 and 3, a sweep of several groups, ``"all"``
and ``run_info["devices"]``, the refusals on both engines, shards on two
CPU "devices" (``cpu`` and ``cpu:0``) run at once in two threads, and a
shard's failure raising out of ``sweep``; the counters and the sync
points that threads share, under a short switch interval.  The cards'
cases are marked
``cuda``, with two sweeps of different shapes in two threads on one
card.  The reference (and ``conftest``) is reached through
fixtures, so the file also collects where JAX is absent.
"""
import threading

import numpy as np
import pytest
import torch

import repro_torch.sim as T
from repro_torch import obs
from repro_torch.cluster import engine, graphs
from repro_torch.core.types import Trace as PortTrace
from repro_torch.workloads import ChainConfig, chained_trace

from test_torch_sweep import assert_bitwise

N_EVENTS = 300
CHUNK = 64
WINDOW = 64
#: The device count the tests patch in: enough for every ``k`` here.
FAKE_DEVICES = 8


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.sim")


@pytest.fixture(scope="module")
def qtrace():
    from conftest import quantized_trace
    return quantized_trace(np.random.default_rng(0), N_EVENTS)


@pytest.fixture(scope="module")
def ctr():
    return chained_trace(ChainConfig(duration_s=200.0, seed=3)).head(
        N_EVENTS)


@pytest.fixture
def shards(monkeypatch):
    """``FAKE_DEVICES`` CPU devices, and the lane count of every shard
    ``_replay``/``_replay_autoscale`` runs, in order."""
    monkeypatch.setattr(engine, "_device_count",
                        lambda device=None: FAKE_DEVICES)
    widths = []
    for name in ("_replay", "_replay_autoscale"):
        real = getattr(engine, name)

        def spy(configs, *a, _real=real, **kw):
            widths.append(len(configs))
            return _real(configs, *a, **kw)
        monkeypatch.setattr(engine, name, spy)
    return widths


def lanes(mod, kind, n=5, tr=None):
    """``n`` lanes of one 2-node group (64 slots a pool), differing in
    their split, routing and cloud pricing, in package ``mod``; ``kind``
    adds the group's knob."""
    routings = ("size_aware", "least_loaded", "sticky", "power_of_two",
                "slack_aware", "cost_model", "size_aware")
    out = []
    lo, hi = (0.55, 0.85) if kind == "autoscale" else (0.25, 0.75)
    for i, f in enumerate(np.linspace(lo, hi, n)):
        kw = dict(small_frac=float(f), routing=routings[i % len(routings)],
                  max_slots=64, cloud_cold_prob=0.1 * (i % 4))
        t = None if tr is None else np.asarray(tr.t)
        if kind in ("failures", "telemetry"):
            a = float(t[len(t) // 4 + 10 * i])
            kw["failures"] = ((a, a + 400.0, i % 2),)
        if kind == "telemetry":
            kw["telemetry"] = WINDOW
        if kind == "autoscale":
            kw["autoscale"] = mod.Autoscale(epoch_events=128, gain=0.2)
        if kind == "chains":
            kw.update(chains=mod.Chains(slack=2.0 + i),
                      telemetry=WINDOW, failures=((100.0, 400.0, 1),))
        if kind == "resize":
            kw["resize"] = mod.Resize("fair_share", min_mb=16.0 * (i % 3))
        out.append(mod.Scenario.cluster((1024.0, 2048.0), name=f"{kind}{i}",
                                        **kw))
    return out


KINDS = {"static": 7, "failures": 5, "telemetry": 5, "autoscale": 5,
         "chains": 5, "resize": 5}


@pytest.fixture(scope="module")
def want(ref, qtrace, ctr):
    """Per kind: the reference's unsharded sweep and the port's, each run
    once."""
    from repro.core.types import Trace as RefTrace
    out = {}
    for kind, n in KINDS.items():
        tr = ctr if kind == "chains" else qtrace
        r = ref.sweep(RefTrace(*tr), lanes(ref, kind, n, tr))
        p = T.sweep(PortTrace(*tr), lanes(T, kind, n, tr), device="cpu")
        out[kind] = (r, p)
    return out


def check(want_pair, got, what, n=None):
    """Every lane of ``got`` equals the reference's and the port's
    unsharded lane, and records its device count."""
    r, p = want_pair
    r, p = r[:n], p[:n]
    assert len(got) == len(r), what
    for i, (a, b, c) in enumerate(zip(r, p, got)):
        assert_bitwise(a, c, (what, "reference", i))
        assert_bitwise(b, c, (what, "port", i))


def width(n, k):
    return -(-n // k)


def run(kind, tr, k, n=None, **kw):
    """The first ``n`` (default all) lanes of ``kind`` in ``k`` shards."""
    return T.sweep(PortTrace(*tr), lanes(T, kind, KINDS[kind], tr)[:n],
                   devices=k, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["gather", "vmap", "fused"])
def test_static_sharded(mode, want, qtrace, shards):
    got = run("static", qtrace, 2, mode=mode)
    check(want["static"], got, mode)
    assert shards == [4, 4]
    assert {g.run_info["devices"] for g in got} == {2}


@pytest.mark.parametrize("kind,k", [("failures", 3), ("telemetry", 2),
                                    ("autoscale", 2), ("chains", 3),
                                    ("resize", 2)])
def test_every_knob_sharded(kind, k, want, qtrace, ctr, shards):
    """Failures, autoscale (``fracs``, ``active``), telemetry windows,
    chains (with an outage and windows) and vertical scaling."""
    got = run(kind, ctr if kind == "chains" else qtrace, k)
    check(want[kind], got, kind)
    assert shards == [width(KINDS[kind], k)] * k


@pytest.mark.parametrize("kind,k,chunk", [("failures", 2, CHUNK),
                                          ("chains", 2, CHUNK),
                                          ("resize", 3, 100)])
def test_chunked_sharded(kind, k, chunk, want, qtrace, ctr, shards):
    """Chunked runs go through the block runner (eagerly on the CPU):
    the shards are of one width, so they share one cached runner, and
    every array a shard returns must be a copy of its reused buffers."""
    before = graphs._cached.cache_info()
    got = run(kind, ctr if kind == "chains" else qtrace, k,
              chunk_events=chunk)
    check(want[kind], got, (kind, chunk))
    assert shards == [width(KINDS[kind], k)] * k
    info = graphs._cached.cache_info()
    assert info.hits - before.hits >= k - 1


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_pad_lanes_every_remainder(n, k, want, qtrace, shards):
    """Lane counts that ``k`` divides and that it does not: the pad lanes
    (copies of lane 0) run and are dropped."""
    got = run("static", qtrace, k, n=n, mode="fused")
    check(want["static"], got, (n, k), n=n)
    assert shards == [width(n, k)] * k


def test_several_groups_sharded(ref, want, qtrace, shards):
    """A sweep of several groups shards each group alone; results keep
    the input order."""
    st, fl = want["static"], want["failures"]
    asc, rz = want["autoscale"], want["resize"]
    picks = [("static", 0, st), ("autoscale", 1, asc),
             ("failures", 2, fl), ("static", 3, st), ("resize", 4, rz),
             ("autoscale", 0, asc), ("static", 5, st)]
    grid = [lanes(T, kind, KINDS[kind], qtrace)[i] for kind, i, _ in picks]
    got = T.sweep(PortTrace(*qtrace), grid, devices=2, device="cpu")
    for (kind, i, (r, p)), g in zip(picks, got):
        assert_bitwise(r[i], g, (kind, i))
        assert_bitwise(p[i], g, (kind, i))
    # static 3 lanes -> [2, 2]; autoscale 2 -> [1, 1]; failures, resize
    # one lane each -> [1, 1]
    assert sorted(shards) == sorted([2, 2, 1, 1, 1, 1, 1, 1])


def test_all_and_run_info(monkeypatch, want, qtrace, shards):
    """``"all"`` is every device of the run's type (three, patched)."""
    monkeypatch.setattr(engine, "_device_count", lambda device=None: 3)
    got = run("static", qtrace, "all", n=4)
    check(want["static"], got, "all", n=4)
    assert {g.run_info["devices"] for g in got} == {3}
    assert shards == [2, 2, 2]
    one = T.simulate(lanes(T, "static", 1)[0], PortTrace(*qtrace).head(10),
                     device="cpu")
    assert one.run_info["devices"] is None
    assert "devices" in one.manifest()["run"]


def test_devices_refusals(monkeypatch, qtrace):
    """A count above the run's devices raises ``ValueError`` before any
    work, on both engines; the oracle then ignores ``devices``."""
    tr = PortTrace(*qtrace).head(30)
    scns = lanes(T, "static", 2)
    assert engine._device_count("cpu") == 1
    assert engine._device_count() >= 1
    assert engine.check_devices("all", "cpu") == 1
    starts = []
    real = engine._replay

    def spy(*a, **kw):
        starts.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(engine, "_replay", spy)
    with pytest.raises(ValueError, match="exceeds the 1 available CPU"):
        T.sweep(tr, scns, devices=2, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        T.sweep(tr, scns, engine="ref", devices=engine._device_count() + 1)
    with pytest.raises(ValueError, match="exceeds"):
        engine._sweep_cluster(tr, [s.to_cluster_config() for s in scns],
                              devices=2, device="cpu")
    assert starts == []
    for bad in (0, -2, 1.5, True, "some", "ALL"):
        with pytest.raises(ValueError, match="devices"):
            T.sweep(tr, scns, devices=bad, device="cpu")
    base = T.sweep(tr, scns, engine="ref")
    for a, b in zip(base, T.sweep(tr, scns, engine="ref", devices=1)):
        assert a.summary() == b.summary()
        assert b.run_info["devices"] is None
    for a, b in zip(T.sweep(tr, scns, device="cpu"),
                    T.sweep(tr, scns, devices=1, device="cpu")):
        assert_bitwise(a, b, "devices=1")
        assert b.run_info["devices"] == 1


def test_shards_on_distinct_devices_run_at_once(monkeypatch, want, qtrace,
                                                shards):
    """Two CPU "devices" (``cpu`` and ``cpu:0``, distinct to torch) make
    two host threads that run their shards at the same time, each with
    its own block runner; the lanes are still bitwise."""
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    monkeypatch.setattr(engine, "_lane_devices",
                        lambda k, device: [devs[j % 2] for j in range(k)])
    meet = threading.Barrier(2, timeout=60)
    seen = []
    real = engine._replay

    def both(configs, trace, device, *a, **kw):
        seen.append((threading.get_ident(), device))
        meet.wait()              # both threads are inside a shard at once
        return real(configs, trace, device, *a, **kw)
    monkeypatch.setattr(engine, "_replay", both)
    got = run("failures", qtrace, 2, chunk_events=CHUNK)
    check(want["failures"], got, "threads")
    assert len({t for t, _ in seen}) == 2
    assert {d for _, d in seen} == set(devs)


def test_a_failed_shard_raises(monkeypatch, qtrace, shards):
    """No fallback: a shard that fails raises out of ``sweep``, after the
    other shards end; nothing reruns it elsewhere."""
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    monkeypatch.setattr(engine, "_lane_devices",
                        lambda k, device: [devs[j % 2] for j in range(k)])
    calls = []
    real = engine._replay

    def failing(configs, trace, device, *a, **kw):
        calls.append(device)
        if device == devs[1]:
            raise RuntimeError("shard lost")
        return real(configs, trace, device, *a, **kw)
    monkeypatch.setattr(engine, "_replay", failing)
    with pytest.raises(RuntimeError, match="shard lost"):
        T.sweep(PortTrace(*qtrace).head(40), lanes(T, "static", 3),
                devices=2, device="cpu")
    assert sorted(map(str, calls)) == ["cpu", "cpu:0"]


def run_threads(n, target, *args):
    """``n`` threads of ``target(i, *args)`` under a short switch
    interval (so a lost update would show); each joined with a
    timeout."""
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=target, args=(i, *args))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)


def test_shared_counters_under_threads(monkeypatch):
    """B1's launch count and the runner's ``STATS`` lose no update when
    16 threads add at once, and the launches a thread tallies apart (a
    capture's) never reach the shared count."""
    from repro_torch.kernels import pool_step
    monkeypatch.setattr(pool_step.evict_place_cuda, "launches", 0)
    monkeypatch.setitem(graphs.STATS, "blocks", 0)
    tallies = {}

    def work(i):
        if i % 4 == 0:
            with pool_step.tally_launches() as tally:
                for _ in range(500):
                    pool_step.add_launches(3)
                tallies[i] = tally()
        for _ in range(2000):
            pool_step.add_launches(1)
            obs.count("blocks", 1)
    run_threads(16, work)
    assert pool_step.evict_place_cuda.launches == 16 * 2000
    assert graphs.STATS["blocks"] == 16 * 2000
    assert tallies == {i: 1500 for i in range(0, 16, 4)}


def test_sync_points_across_threads(monkeypatch):
    """The sync debug mode is process-wide: while any thread is inside a
    sync point it stays lifted (another thread's exit must not turn it
    back on), and the last exit restores the caller's mode."""
    from repro_torch import _device
    mode = {"now": 2}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__("now", m))
    seen = []
    card = torch.device("cuda")

    def work(i):
        for _ in range(300):
            with _device.sync_point(card):
                seen.append(mode["now"])
                with _device.sync_point(card):     # nested, same thread
                    seen.append(mode["now"])
    run_threads(12, work)
    assert len(seen) == 12 * 300 * 2 and set(seen) == {0}
    assert mode["now"] == 2 and _device._SYNC["depth"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gather", "fused"])
def test_sharded_on_the_card(mode):
    """On the card: ``devices="all"`` equals the unsharded sweep and the
    CPU's; with one card, a count above it raises before any launch.
    With two cards or more, B1 launches on each shard's card (a launch
    on ``cuda:1`` with ``cuda:0`` current)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    from repro_torch.kernels.pool_step import evict_place_cuda
    from repro_torch.workloads import quickstart_trace
    tr = quickstart_trace().head(200)
    scns = lanes(T, "failures", 5, tr)
    n = torch.cuda.device_count()
    want = T.sweep(tr, scns, mode=mode, chunk_events=CHUNK, device="cpu")
    base = T.sweep(tr, scns, mode=mode, chunk_events=CHUNK)
    before = evict_place_cuda.launches
    got = T.sweep(tr, scns, mode=mode, chunk_events=CHUNK, devices="all")
    assert evict_place_cuda.launches - before == (
        n * len(tr) if mode == "fused" else 0)
    for w, b, g in zip(want, base, got):
        assert_bitwise(w, g, mode)
        assert_bitwise(b, g, mode)
        assert g.run_info["devices"] == n
    with pytest.raises(ValueError, match="exceeds"):
        T.sweep(tr, scns, mode=mode, devices=n + 1)
    assert evict_place_cuda.launches - before == (
        n * len(tr) if mode == "fused" else 0)
    if n >= 2:
        from repro_torch.kernels.pool_step import evict_place_plain
        from test_torch_pool_step_kernel import random_batch
        args = [torch.from_numpy(a).to("cuda:1")
                for a in random_batch(np.random.default_rng(1), 3, 256)]
        with torch.cuda.device(0):
            out = evict_place_cuda(*args)
        for a, b in zip(out, evict_place_plain(*args)):
            assert a.device == torch.device("cuda", 1)
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_two_threads_on_one_card():
    """Two sweeps of different shapes in two host threads at once on one
    card, under ``set_sync_debug_mode("error")``: each captures its own
    runner while the other launches (``thread_local`` capture), the sync
    points of one do not turn the guard back on inside the other's, each
    lane equals its sweep run alone, and B1's count and the captures are
    exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    from repro_torch.kernels.pool_step import evict_place_cuda
    from repro_torch.workloads import quickstart_trace
    tr = quickstart_trace().head(1500)
    grids = {
        "a": [T.Scenario.cluster((1024.0, 2048.0, 1024.0), small_frac=f,
                                 max_slots=128, failures=((300.0, 900.0, 1),),
                                 telemetry=256) for f in (0.3, 0.5, 0.7)],
        "b": [T.Scenario.kiss(m * 1024.0, max_slots=256)
              for m in (2, 4, 8, 16, 3)]}
    alone = {k: T.sweep(tr, s, mode="fused", chunk_events=500)
             for k, s in grids.items()}
    graphs._cached.cache_clear()
    out, errors = {}, []
    start = threading.Barrier(2, timeout=60)

    def work(k):
        try:
            start.wait()
            out[k] = T.sweep(tr, grids[k], mode="fused", chunk_events=500)
        except BaseException as e:        # reported by the main thread
            errors.append((k, e))
    launches, captures = evict_place_cuda.launches, graphs.STATS["captures"]
    threads = [threading.Thread(target=work, args=(k,)) for k in grids]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for k in grids:
        for w, g in zip(alone[k], out[k]):
            assert_bitwise(w, g, k)
    assert evict_place_cuda.launches - launches == 2 * len(tr)
    assert graphs.STATS["captures"] - captures == 2
