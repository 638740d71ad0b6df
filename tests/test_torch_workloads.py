"""The port's workload generators, Azure-2019 ingest and analyzer
against the reference's, on the CPU: the same numpy and seed give
identical arrays (dtypes included), the CSV writer identical bytes, and
each package's reader takes the other's files.  Also the stored
benchmark tables (``benchmark_replay_tables``): the reference's tables
under this numpy, and ``trace_from_tables`` of them the stored replay
trace.  The reference is reached through fixtures, so the file also
collects where JAX is absent.
"""
import dataclasses
import os

import numpy as np
import pytest

import repro_torch.core.analyzer as PA
import repro_torch.workloads as PW
from repro_torch.workloads import replay as PR

#: A non-default schema: every knob of ``SchemaConfig`` moved.
SMALL_SCHEMA = dict(n_funcs=60, n_minutes=90, rpm_total=150.0,
                    large_frac=0.2, small_large_ratio=4.0, funcs_per_app=2,
                    zipf_a=1.5, diurnal_depth=0.5, seed=7)
#: A non-default replay mapping.
REPLAY_CFG = dict(threshold_mb=100.0, cold_base_s=1.0, cold_per_mb_s=0.05,
                  cold_sigma=0.6, seed=3)
BENCH_SCHEMA = dict(n_funcs=400, n_minutes=240, rpm_total=700.0, seed=0)


@pytest.fixture(scope="module")
def ref():
    return pytest.importorskip("repro.workloads")


@pytest.fixture(scope="module")
def ref_analyzer():
    return pytest.importorskip("repro.core.analyzer")


def same_arrays(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape and a.tobytes() == b.tobytes(), what


def same_trace(r, p, what=""):
    assert r._fields == p._fields
    for f in r._fields:
        x, y = getattr(r, f), getattr(p, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            same_arrays(x, y, (what, f))


def same_tables(r, p, what=""):
    for f in dataclasses.fields(r):
        x, y = getattr(r, f.name), getattr(p, f.name)
        if isinstance(x, np.ndarray):
            same_arrays(x, y, (what, f.name))
        else:
            assert tuple(x) == tuple(y), (what, f.name)


@pytest.mark.parametrize("name,kw", [
    ("bursty_trace", dict(seed=1, duration_s=1800.0)),
    ("steady_trace", dict(seed=2, duration_s=1800.0)),
    ("stress_trace", dict(seed=0, duration_s=60.0, rps=200.0)),
    ("edge_trace", dict(seed=3, duration_s=900.0, scale=2.0)),
])
def test_trace_generators_match_the_reference(ref, name, kw):
    r, p = getattr(ref, name)(**kw), getattr(PW, name)(**kw)
    assert len(p) > 100
    same_trace(r, p, name)


def test_stress_trace_defaults_match_the_reference(ref):
    """The default rate over a short span (the default 2 h is 5.3
    million events)."""
    same_trace(ref.stress_trace(duration_s=30.0),
               PW.stress_trace(duration_s=30.0), "stress")


@pytest.mark.parametrize("kw", [{}, dict(n_apps=120, seed=3,
                                         large_frac=0.4)])
def test_synthesize_apps_matches_the_reference(ref, kw):
    r, p = ref.synthesize_apps(**kw), PW.synthesize_apps(**kw)
    for f in dataclasses.fields(r):
        same_arrays(getattr(r, f.name), getattr(p, f.name), f.name)
    same_arrays(r.function_memory(), p.function_memory(), "function_memory")


@pytest.mark.parametrize("kw", [{}, SMALL_SCHEMA])
def test_schema_tables_match_the_reference(ref, kw):
    r = ref.synthesize_azure_schema(ref.SchemaConfig(**kw))
    p = PW.synthesize_azure_schema(PW.SchemaConfig(**kw))
    same_tables(r, p, kw)
    assert (r.n_functions, r.n_minutes, r.n_invocations) == \
        (p.n_functions, p.n_minutes, p.n_invocations)


@pytest.fixture(scope="module")
def small_tables():
    return PW.synthesize_azure_schema(PW.SchemaConfig(**SMALL_SCHEMA))


@pytest.fixture(scope="module")
def csv_dirs(ref, small_tables, tmp_path_factory):
    """The small tables written by each package (the reference writes
    its own tables of the same config), with their paths."""
    root = tmp_path_factory.mktemp("azure")
    rt = ref.synthesize_azure_schema(ref.SchemaConfig(**SMALL_SCHEMA))
    return {"ref": ref.write_azure_csvs(rt, str(root / "ref"), day=3),
            "port": PW.write_azure_csvs(small_tables, str(root / "port"),
                                        day=3)}


def test_csv_writer_bytes_match_the_reference(csv_dirs):
    for r, p in zip(csv_dirs["ref"], csv_dirs["port"]):
        assert os.path.basename(r) == os.path.basename(p)
        with open(r, "rb") as a, open(p, "rb") as b:
            assert a.read() == b.read(), os.path.basename(p)


def test_each_reader_takes_the_others_files(ref, csv_dirs, small_tables):
    by_port = PW.read_azure_csvs(*csv_dirs["ref"])
    by_ref = ref.read_azure_csvs(*csv_dirs["port"])
    same_tables(by_ref, by_port, "cross")
    # the reader canonicalizes row order; the trace round-trips
    same_trace(PW.trace_from_tables(small_tables),
               PW.trace_from_tables(by_port), "round trip")
    same_trace(ref.trace_from_tables(by_ref), PW.trace_from_tables(by_port))
    same_trace(ref.load_azure_trace(*csv_dirs["port"]),
               PW.load_azure_trace(*csv_dirs["ref"]), "load_azure_trace")


def _shuffle_rows(path, out, rng):
    with open(path, newline="") as f:
        lines = f.read().splitlines(keepends=True)
    body = lines[1:]
    order = rng.permutation(len(body))
    with open(out, "w", newline="") as f:
        f.writelines([lines[0]] + [body[i] for i in order])


def test_shuffled_csv_rows_give_the_same_trace(ref, csv_dirs, tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for p in csv_dirs["port"]:
        out = tmp_path / os.path.basename(p)
        _shuffle_rows(p, out, rng)
        paths.append(str(out))
    with open(csv_dirs["port"][0], "rb") as a, open(paths[0], "rb") as b:
        assert a.read() != b.read()
    want = PW.load_azure_trace(*csv_dirs["port"])
    same_trace(want, PW.load_azure_trace(*paths), "shuffled")
    same_trace(ref.load_azure_trace(*paths), want, "shuffled, reference")


@pytest.mark.parametrize("kw", [{}, REPLAY_CFG])
def test_trace_from_tables_matches_the_reference(ref, small_tables, kw):
    rt = ref.synthesize_azure_schema(ref.SchemaConfig(**SMALL_SCHEMA))
    r = ref.trace_from_tables(rt, ref.ReplayConfig(**kw))
    p = PW.trace_from_tables(small_tables, PW.ReplayConfig(**kw))
    assert len(p) == small_tables.n_invocations
    same_trace(r, p, kw)


def test_missing_rows_fall_back_as_the_reference(ref, csv_dirs, tmp_path):
    """Functions missing from the duration table and apps missing from
    the memory table take the median curves in both packages."""
    paths = []
    for i, p in enumerate(csv_dirs["port"]):
        with open(p, newline="") as f:
            lines = f.read().splitlines(keepends=True)
        if i:                            # keep every third row
            lines = lines[:1] + lines[1::3]
        out = tmp_path / os.path.basename(p)
        out.write_text("".join(lines), newline="")
        paths.append(str(out))
    same_tables(ref.read_azure_csvs(*paths), PW.read_azure_csvs(*paths))
    same_trace(ref.load_azure_trace(*paths), PW.load_azure_trace(*paths))


def _broken(kind, paths, tmp_path):
    """The three paths with one broken as ``kind`` says."""
    inv, dur, mem = paths
    if kind == "missing file":
        return inv, str(tmp_path / "absent.csv"), mem
    with open(inv, newline="") as f:
        lines = f.read().splitlines(keepends=True)
    out = tmp_path / f"{kind.replace(' ', '_')}.csv"
    if kind == "missing column":
        out.write_text(lines[0].replace("HashFunction", "HashFn")
                       + "".join(lines[1:]), newline="")
    elif kind == "no rows":
        out.write_text(lines[0], newline="")
    else:                                       # a non-integer minute
        out.write_text(lines[0].replace(",1,", ",one,", 1)
                       + "".join(lines[1:]), newline="")
    return str(out), dur, mem


@pytest.mark.parametrize("kind", ["missing column", "missing file",
                                  "no rows", "bad minute column"])
def test_reader_errors_match_the_reference(ref, csv_dirs, tmp_path, kind):
    paths = _broken(kind, csv_dirs["port"], tmp_path)
    with pytest.raises(Exception) as want:
        ref.read_azure_csvs(*paths)
    with pytest.raises(type(want.value)) as got:
        PW.read_azure_csvs(*paths)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, (ValueError, FileNotFoundError))


def test_empty_tables_give_an_empty_trace(ref):
    cfg = dict(n_funcs=5, n_minutes=3, rpm_total=0.0)
    r = ref.trace_from_tables(ref.synthesize_azure_schema(
        ref.SchemaConfig(**cfg)))
    p = PW.trace_from_tables(PW.synthesize_azure_schema(
        PW.SchemaConfig(**cfg)))
    assert len(p) == 0
    same_trace(r, p, "empty")


@pytest.fixture(scope="module")
def edge():
    return PW.quickstart_trace()


def test_analyzer_matches_the_reference(ref_analyzer, edge):
    from repro.core.types import Trace as RefTrace
    rt = RefTrace(*edge)
    for th in (225.0, 100.0):
        r, p = ref_analyzer.analyze(rt, th), PA.analyze(edge, th)
        assert dataclasses.asdict(r) == dataclasses.asdict(p), th
        assert r.suggested_small_frac == p.suggested_small_frac
        same_arrays(ref_analyzer.classify(rt.size_mb, th),
                    PA.classify(edge.size_mb, th), "classify")
    for bucket in (60.0, 300.0):
        r = ref_analyzer.invocation_ratio(rt, bucket)
        p = PA.invocation_ratio(edge, bucket)
        assert r.keys() == p.keys() and r["ratio"] == p["ratio"]
        same_arrays(r["small"], p["small"], "small")
        same_arrays(r["large"], p["large"], "large")
    for kw in ({}, dict(window_s=900.0, stride_s=300.0, z_thresh=2.0)):
        r = ref_analyzer.sliding_window_iats(rt, **kw)
        p = PA.sliding_window_iats(edge, **kw)
        for k in ("small", "large"):
            same_arrays(r[k], p[k], (kw, k))
    for a, b in zip(ref_analyzer.percentile_distribution(edge.cold_dur),
                    PA.percentile_distribution(edge.cold_dur)):
        same_arrays(a, b, "percentiles")
    x = np.asarray(edge.size_mb[:50], np.float64)
    same_arrays(ref_analyzer.estimate_function_memory(x, x / 3, x / 2),
                PA.estimate_function_memory(x, x / 3, x / 2), "eq1")


def test_analyzer_on_an_empty_trace(ref_analyzer, edge):
    from repro.core.types import Trace as RefTrace
    empty = edge.head(0)
    r = ref_analyzer.analyze(RefTrace(*empty))
    assert dataclasses.asdict(r) == dataclasses.asdict(PA.analyze(empty))


def test_stored_tables_are_the_references(ref):
    """The stored tables are the reference's under numpy 2.0, the numpy
    they were drawn with (``Generator.zipf`` differs under 2.3)."""
    if not np.__version__.startswith("2.0."):
        pytest.skip(f"the tables were stored under numpy 2.0, this is "
                    f"{np.__version__}")
    same_tables(ref.synthesize_azure_schema(ref.SchemaConfig(
        **BENCH_SCHEMA)), PW.benchmark_replay_tables(), "stored")


def test_stored_tables_give_the_stored_replay_trace():
    tables = PW.benchmark_replay_tables()
    assert (tables.n_functions, tables.n_minutes) == (400, 240)
    trace = PW.trace_from_tables(tables)
    assert len(trace) == tables.n_invocations == 192_047
    same_trace(PW.benchmark_replay_trace(), trace, "replay")
    assert PR.BENCHMARK_TABLES_FILE.stat().st_size < 100_000
