"""Azure Functions 2019 trace replay: the public schema -> ``Trace``.

A numpy copy of ``repro.workloads.replay``: the same tables, CSV bytes
and traces under the same numpy.  The public release ships three
per-day CSV families:

* ``invocations_per_function_md.anon.dDD.csv`` — per-function,
  minute-bucketed invocation counts (columns ``HashOwner, HashApp,
  HashFunction, Trigger, 1, 2, ..., 1440``);
* ``function_durations_percentiles.anon.dDD.csv`` — per-function
  execution-duration percentiles in **milliseconds** (``Average, Count,
  Minimum, Maximum, percentile_Average_{0,1,25,50,75,99,100}``);
* ``app_memory_percentiles.anon.dDD.csv`` — per-app allocated-memory
  percentiles in **MB** (``SampleCount, AverageAllocatedMb,
  AverageAllocatedMb_pct{1,5,25,50,75,95,99,100}``).

:func:`load_azure_trace` maps them onto
:class:`repro_torch.core.types.Trace`:

* **deterministic intra-minute placement** — a minute bucket with ``k``
  invocations becomes ``k`` evenly spaced events with a per-(function,
  minute) phase derived from the function's stable hash, so replays are
  reproducible bit-for-bit regardless of CSV row order;
* **percentile-sampled durations and sizes** — warm durations are
  inverse-CDF draws from the function's duration-percentile curve,
  container sizes one inverse-CDF draw per function from its app's
  memory-percentile curve;
* **the simulator's exactness grid** — times and durations are quantized
  to the 1/64 s grid and sizes to whole MB, so float32 pool arithmetic
  stays exact and every engine agrees bitwise on replayed traces;
* **modeled cold starts** — the dataset has no cold-start column, so
  ``cold_dur`` = warm + a size-affine lognormal overhead calibrated to
  the paper's Fig 5 percentiles (``EXPERIMENTS.md``, §Replay
  calibration).

The dataset itself is not redistributable, so
:func:`synthesize_azure_schema` generates *schema-faithful* tables (Zipf
popularity, diurnal minute counts, bimodal small/large app memory) and
:func:`write_azure_csvs` emits them in the exact public format; swapping
in the real CSVs is a path change.

The vertical benchmark's tables and its trace are stored as the
reference draws them under numpy 2.0 (:func:`benchmark_replay_tables`,
:func:`benchmark_replay_trace`): ``synthesize_azure_schema`` draws its
popularity with ``Generator.zipf``, whose stream numpy 2.3 changed.
:func:`trace_from_tables` draws with ``SeedSequence``, ``random`` and
``lognormal`` only, so the stored tables give the stored trace under
either numpy.  Million-invocation replays run through
``repro_torch.sim.simulate(..., chunk_events=65536)``.
"""
from __future__ import annotations

import csv
import dataclasses
import hashlib
import os
from pathlib import Path

import numpy as np

from ..core.types import Trace

_Q = 64.0                     # time quantum: 1/64 s (shared with azure.py)

#: Percentile levels of the duration table, in column order.
DURATION_PCT_LEVELS = (0.0, 1.0, 25.0, 50.0, 75.0, 99.0, 100.0)
#: Percentile levels of the app-memory table, in column order.
MEMORY_PCT_LEVELS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0, 100.0)

MINUTES_PER_DAY = 1440

_DUR_COLS = tuple(f"percentile_Average_{int(p)}" for p in DURATION_PCT_LEVELS)
_MEM_COLS = tuple(f"AverageAllocatedMb_pct{int(p)}" for p in MEMORY_PCT_LEVELS)


def _quant(x: np.ndarray) -> np.ndarray:
    return np.round(np.asarray(x) * _Q) / _Q


def _stable_u64(*parts: str) -> int:
    """A stable 64-bit hash of the key strings — NOT python's salted
    ``hash``; replays must place the same timestamps across processes."""
    h = hashlib.blake2s("\x1f".join(parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


@dataclasses.dataclass(frozen=True, eq=False)
class AzureTables:
    """The three public tables in array form, joined on function identity.

    Rows are canonicalized: functions sorted by ``(owner, app, func)``
    hash strings, so two CSV files with the same rows in any order build
    the same tables (and therefore the same trace).  ``counts`` may have
    any number of minute columns — a single public day has 1440, but
    concatenated multi-day tables are fine.
    """

    owners: tuple[str, ...]        # [F] HashOwner per function
    apps: tuple[str, ...]          # [F] HashApp per function
    funcs: tuple[str, ...]         # [F] HashFunction per function
    triggers: tuple[str, ...]      # [F] Trigger per function
    counts: np.ndarray             # i64[F, M] invocations per minute
    dur_pcts: np.ndarray           # f64[F, 7] duration percentiles (ms)
    mem_apps: tuple[tuple[str, str], ...]  # [A] (HashOwner, HashApp)
    mem_pcts: np.ndarray           # f64[A, 8] allocated-MB percentiles

    @property
    def n_functions(self) -> int:
        return len(self.funcs)

    @property
    def n_minutes(self) -> int:
        return int(self.counts.shape[1])

    @property
    def n_invocations(self) -> int:
        return int(self.counts.sum())


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Knobs for mapping the schema onto the simulator's event model."""

    #: KiSS size-class threshold (paper §2.5.1): size >= threshold = large.
    threshold_mb: float = 225.0
    #: Cold-start overhead model (the dataset has no cold column):
    #: ``overhead = (base + per_mb * size) * lognormal(0, sigma)``,
    #: calibrated to Fig 5 (small ~11 s p85, large ~60 s p85 — see
    #: EXPERIMENTS.md §Replay calibration).
    cold_base_s: float = 2.0
    cold_per_mb_s: float = 0.16
    cold_sigma: float = 0.35
    #: Salt for every deterministic draw (phases, percentile uniforms).
    seed: int = 0


# --------------------------------------------------------------------------
# CSV ingest
# --------------------------------------------------------------------------

def _read_rows(path: str, required: tuple[str, ...]) -> list[dict]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        missing = [c for c in required if c not in (reader.fieldnames or ())]
        if missing:
            raise ValueError(
                f"{os.path.basename(path)}: missing schema columns "
                f"{missing}; got {reader.fieldnames}")
        return list(reader)


def read_azure_csvs(invocations_csv: str, durations_csv: str,
                    memory_csv: str) -> AzureTables:
    """Read one day of the public schema into :class:`AzureTables`.

    Tolerates what the real dataset throws at you: rows in any order
    (functions are canonicalized by hash), functions missing from the
    duration table and apps missing from the memory table (both fall back
    to the column-wise median curve of the functions that *are* present),
    and empty minute buckets (zero counts).
    """
    inv_rows = _read_rows(invocations_csv,
                          ("HashOwner", "HashApp", "HashFunction"))
    if not inv_rows:
        raise ValueError(f"{invocations_csv}: no invocation rows")
    minute_cols = [c for c in inv_rows[0].keys()
                   if c not in ("HashOwner", "HashApp", "HashFunction",
                                "Trigger")]
    try:
        minute_cols.sort(key=int)
    except ValueError:
        raise ValueError(
            f"{invocations_csv}: minute columns must be integer-named, "
            f"got {minute_cols[:5]}...") from None
    inv_rows.sort(key=lambda r: (r["HashOwner"], r["HashApp"],
                                 r["HashFunction"]))

    dur_rows = _read_rows(durations_csv,
                          ("HashOwner", "HashApp", "HashFunction")
                          + _DUR_COLS)
    dur_by_key = {(r["HashOwner"], r["HashApp"], r["HashFunction"]):
                  [float(r[c]) for c in _DUR_COLS] for r in dur_rows}
    mem_rows = _read_rows(memory_csv, ("HashOwner", "HashApp") + _MEM_COLS)
    mem_by_key = {(r["HashOwner"], r["HashApp"]):
                  [float(r[c]) for c in _MEM_COLS] for r in mem_rows}

    owners, apps, funcs, triggers, counts, durs = [], [], [], [], [], []
    dur_fallback = (np.median(np.asarray(list(dur_by_key.values())), axis=0)
                    if dur_by_key else np.full(len(_DUR_COLS), 1000.0))
    for r in inv_rows:
        key = (r["HashOwner"], r["HashApp"], r["HashFunction"])
        owners.append(key[0])
        apps.append(key[1])
        funcs.append(key[2])
        triggers.append(r.get("Trigger", ""))
        counts.append([int(float(r[c] or 0)) for c in minute_cols])
        durs.append(dur_by_key.get(key, dur_fallback))
    mem_apps = tuple(sorted(mem_by_key))
    mem_pcts = (np.asarray([mem_by_key[k] for k in mem_apps], np.float64)
                if mem_apps else np.zeros((0, len(_MEM_COLS))))
    return AzureTables(
        owners=tuple(owners), apps=tuple(apps), funcs=tuple(funcs),
        triggers=tuple(triggers),
        counts=np.asarray(counts, np.int64),
        dur_pcts=np.asarray(durs, np.float64),
        mem_apps=mem_apps, mem_pcts=mem_pcts)


def write_azure_csvs(tables: AzureTables, out_dir: str,
                     day: int = 1) -> tuple[str, str, str]:
    """Emit ``tables`` as the three public-schema CSVs (the exact column
    names of the dataset release).  Returns the three paths —
    ``read_azure_csvs(*paths)`` round-trips bit-for-bit."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"anon.d{day:02d}.csv"
    inv = os.path.join(out_dir, f"invocations_per_function_md.{tag}")
    dur = os.path.join(out_dir, f"function_durations_percentiles.{tag}")
    mem = os.path.join(out_dir, f"app_memory_percentiles.{tag}")
    m = tables.n_minutes
    with open(inv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["HashOwner", "HashApp", "HashFunction", "Trigger"]
                   + [str(i + 1) for i in range(m)])
        for i in range(tables.n_functions):
            w.writerow([tables.owners[i], tables.apps[i], tables.funcs[i],
                        tables.triggers[i]]
                       + [int(c) for c in tables.counts[i]])
    with open(dur, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["HashOwner", "HashApp", "HashFunction", "Average",
                    "Count", "Minimum", "Maximum"] + list(_DUR_COLS))
        for i in range(tables.n_functions):
            p = tables.dur_pcts[i]
            # percentile columns use repr-exact floats so the round trip
            # is bitwise (the summary columns stay cosmetic)
            w.writerow([tables.owners[i], tables.apps[i], tables.funcs[i],
                        f"{p[3]:.2f}", int(tables.counts[i].sum()),
                        f"{p[0]:.2f}", f"{p[-1]:.2f}"]
                       + [f"{v:.17g}" for v in p])
    with open(mem, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["HashOwner", "HashApp", "SampleCount",
                    "AverageAllocatedMb"] + list(_MEM_COLS))
        for a, (owner, app) in enumerate(tables.mem_apps):
            p = tables.mem_pcts[a]
            w.writerow([owner, app, 256, f"{p[3]:.2f}"]
                       + [f"{v:.17g}" for v in p])
    return inv, dur, mem


# --------------------------------------------------------------------------
# tables -> Trace
# --------------------------------------------------------------------------

def _interp_pcts(u: np.ndarray, levels, values: np.ndarray) -> np.ndarray:
    """Inverse-CDF sample: ``u`` in [0, 1] against a percentile curve.
    A ``u`` landing exactly on a level returns that column's value, so
    boundary draws are deterministic; the curve is made monotone first
    (the real dataset has occasional non-monotone rows)."""
    values = np.maximum.accumulate(np.asarray(values, np.float64))
    return np.interp(u, np.asarray(levels) / 100.0, values)


def trace_from_tables(tables: AzureTables,
                      cfg: ReplayConfig = ReplayConfig()) -> Trace:
    """Deterministically expand minute-bucketed tables into a sorted,
    quantized :class:`Trace`.

    Function ids are dense int32 in canonical (hash-sorted) row order —
    the row order of the tables themselves is irrelevant, so shuffled
    CSVs replay bit-identically.  A minute bucket with ``k`` invocations
    places them at ``60 * (m + (i + phase) / k)`` for ``i in 0..k-1`` —
    evenly spaced, with a per-(function, minute) phase in [0, 1) derived
    from the function's stable hash so streams interleave instead of
    stacking on minute boundaries.  All draws are keyed by the hash
    strings + ``cfg.seed``, never by row order.
    """
    f32, i32 = np.float32, np.int32
    n_funcs = tables.n_functions
    canon = sorted(range(n_funcs),
                   key=lambda i: (tables.owners[i], tables.apps[i],
                                  tables.funcs[i]))
    mem_idx = {k: i for i, k in enumerate(tables.mem_apps)}
    mem_fallback = (np.median(tables.mem_pcts, axis=0)
                    if len(tables.mem_apps)
                    else np.full(len(_MEM_COLS), 128.0))

    ts, fids, sizes, clss, warms, colds = [], [], [], [], [], []
    for fid, i in enumerate(canon):
        counts = tables.counts[i]
        total = int(counts.sum())
        if total == 0:
            continue              # a function with only empty buckets
        key = (tables.owners[i], tables.apps[i], tables.funcs[i])
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, _stable_u64(*key)]))
        # one size draw per function from its app's memory curve
        mem_row = tables.mem_pcts[mem_idx[key[:2]]] \
            if key[:2] in mem_idx else mem_fallback
        size = float(np.maximum(
            np.round(_interp_pcts(rng.random(), MEMORY_PCT_LEVELS,
                                  mem_row)), 1.0))
        # deterministic intra-minute placement
        minutes = np.nonzero(counts)[0]
        phases = rng.random(tables.n_minutes)
        t_f = np.concatenate([
            60.0 * (m + (np.arange(counts[m]) + phases[m]) / counts[m])
            for m in minutes]) if len(minutes) else np.zeros(0)
        # per-invocation warm durations off the percentile curve (ms -> s)
        warm = _interp_pcts(rng.random(total), DURATION_PCT_LEVELS,
                            tables.dur_pcts[i]) / 1000.0
        # modeled cold overhead: size-affine with lognormal jitter
        over = ((cfg.cold_base_s + cfg.cold_per_mb_s * size)
                * rng.lognormal(0.0, cfg.cold_sigma, total))
        ts.append(t_f)
        fids.append(np.full(total, fid, i32))
        sizes.append(np.full(total, size, f32))
        clss.append(np.full(total, int(size >= cfg.threshold_mb), i32))
        warms.append(warm)
        colds.append(over)
    if not ts:
        z = np.zeros(0)
        return Trace(t=z.astype(f32), func_id=z.astype(i32),
                     size_mb=z.astype(f32), cls=z.astype(i32),
                     warm_dur=z.astype(f32), cold_dur=z.astype(f32))
    t = _quant(np.concatenate(ts))
    order = np.argsort(t, kind="stable")
    warm = np.maximum(_quant(np.concatenate(warms)), 1 / _Q)
    cold_extra = np.maximum(_quant(np.concatenate(colds)), 1 / _Q)
    return Trace(
        t=t[order].astype(f32),
        func_id=np.concatenate(fids)[order],
        size_mb=np.concatenate(sizes)[order],
        cls=np.concatenate(clss)[order],
        warm_dur=warm[order].astype(f32),
        cold_dur=(warm + cold_extra)[order].astype(f32),
    )


def load_azure_trace(invocations_csv: str, durations_csv: str,
                     memory_csv: str,
                     cfg: ReplayConfig = ReplayConfig()) -> Trace:
    """The one-call ingest path: public-schema CSVs -> simulator trace.

    Point it at one day of the Azure Functions 2019 release (or at the
    schema-faithful CSVs :func:`write_azure_csvs` emits).  Slice the
    result with ``Trace.head(n)`` / ``Trace.window(t0, t1)`` for
    CI-sized prefixes, and replay million-invocation days through
    ``simulate(..., chunk_events=65536)``.
    """
    return trace_from_tables(
        read_azure_csvs(invocations_csv, durations_csv, memory_csv), cfg)


# --------------------------------------------------------------------------
# schema-faithful synthetic fallback
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchemaConfig:
    """Scale knobs for :func:`synthesize_azure_schema`.

    Defaults give a CI-sized table; the ``replay`` benchmark scales
    ``rpm_total`` / ``n_minutes`` up to the paper's millions of
    invocations.  Statistics mirror the paper's workload analysis: Zipf
    function popularity (a few functions dominate), diurnal minute
    rates, bimodal app memory (small 30-60 MB, large 300-400 MB,
    §4.2), and lognormal-shaped duration percentile curves.
    """

    n_funcs: int = 120
    n_minutes: int = 240
    rpm_total: float = 300.0      # mean invocations/minute, cluster-wide
    large_frac: float = 0.08      # fraction of *apps* in the large band
    small_large_ratio: float = 5.0  # aggregate small:large rate (Fig 3)
    funcs_per_app: int = 3        # mean functions per app
    zipf_a: float = 1.3
    diurnal_depth: float = 0.3
    seed: int = 0


def synthesize_azure_schema(
        cfg: SchemaConfig = SchemaConfig()) -> AzureTables:
    """Generate :class:`AzureTables` matching the public schema's shape
    and the paper's documented statistics — so tests, CI, and benchmarks
    exercise the full ingest path without the non-redistributable
    dataset.  Deterministic in ``cfg.seed`` under one numpy (its
    ``Generator.zipf`` stream changed in numpy 2.3)."""
    rng = np.random.default_rng(cfg.seed)
    n, m = cfg.n_funcs, cfg.n_minutes
    n_apps = max(1, n // max(cfg.funcs_per_app, 1))
    app_of = np.sort(rng.integers(0, n_apps, n))

    def hx(kind: str, i: int) -> str:
        return hashlib.blake2s(f"{cfg.seed}/{kind}/{i}".encode(),
                               digest_size=16).hexdigest()

    app_owner = [hx("owner", a % max(n_apps // 2, 1)) for a in range(n_apps)]
    app_hash = [hx("app", a) for a in range(n_apps)]

    # app memory band decides both size class and rate share: the paper's
    # Fig 3 has small functions invoking ~4-6.5x more than large in
    # aggregate, so the Zipf popularity weights are normalized *within*
    # each band (exactly like azure.py pins per-class aggregate rps)
    n_large_apps = max(1, round(cfg.large_frac * n_apps)) \
        if cfg.large_frac > 0 else 0
    large_app = np.zeros(n_apps, bool)
    large_app[rng.permutation(n_apps)[:n_large_apps]] = True
    large_fn = large_app[app_of]

    w = np.minimum(rng.zipf(cfg.zipf_a, size=n).astype(np.float64), 1e4)
    r = cfg.small_large_ratio
    share = np.where(large_fn, 1.0 / (1.0 + r), r / (1.0 + r))
    for band in (large_fn, ~large_fn):
        if band.any():
            w[band] /= w[band].sum()
    rates = cfg.rpm_total * share * w            # invocations/minute
    if not large_fn.any() or large_fn.all():     # one band only: use all
        rates = cfg.rpm_total * w
    minutes = np.arange(m)
    diurnal = 1.0 + cfg.diurnal_depth * np.sin(
        2 * np.pi * minutes / MINUTES_PER_DAY)
    counts = rng.poisson(rates[:, None] * diurnal[None, :]).astype(np.int64)

    # app memory percentile curves: bimodal small/large base, monotone
    # spread factors around the base (pct50 == base)
    base = np.where(large_app, rng.uniform(300, 400, n_apps),
                    rng.uniform(30, 60, n_apps))
    spread = np.array([0.6, 0.7, 0.85, 1.0, 1.15, 1.35, 1.5, 1.7])
    mem_pcts = base[:, None] * spread[None, :]

    # duration percentile curves: lognormal-shaped around a per-function
    # median (large apps run longer, as in the paper's Fig 4/5 setup);
    # z-scores of the schema's fixed levels, with the open 0th/100th
    # percentiles clipped at +/-3.5 sigma (the dataset's Min/Max are
    # finite samples of an open-tailed distribution anyway)
    z = np.array([-3.5, -2.3263478740408408, -0.6744897501960817, 0.0,
                  0.6744897501960817, 2.3263478740408408, 3.5])
    med_s = np.where(large_fn, rng.lognormal(np.log(2.0), 0.5, n),
                     rng.lognormal(np.log(0.5), 0.5, n))
    sigma = rng.uniform(0.5, 1.0, n)
    dur_pcts = 1000.0 * med_s[:, None] * np.exp(sigma[:, None] * z[None, :])

    return AzureTables(
        owners=tuple(app_owner[a] for a in app_of),
        apps=tuple(app_hash[a] for a in app_of),
        funcs=tuple(hx("func", i) for i in range(n)),
        triggers=tuple(rng.choice(("http", "timer", "queue", "event"), n)),
        counts=counts,
        dur_pcts=dur_pcts,
        mem_apps=tuple(zip(app_owner, app_hash)),
        mem_pcts=mem_pcts)


# --------------------------------------------------------------------------
# the vertical benchmark's replay, stored
# --------------------------------------------------------------------------

#: ``synthesize_azure_schema(SchemaConfig(n_funcs=400, n_minutes=240,
#: rpm_total=700.0, seed=0))`` as the reference draws it under numpy 2.0.
BENCHMARK_TABLES_FILE = Path(__file__).with_name(
    "azure_tables_seed0_240min.npz")
#: ``trace_from_tables`` of those tables (``benchmarks/vertical.py``'s
#: replay): 192,047 invocations of 400 functions over four hours.
BENCHMARK_REPLAY_FILE = Path(__file__).with_name(
    "azure_replay_seed0_240min.npz")


def _load_tables(path) -> AzureTables:
    """:class:`AzureTables` from an ``.npz`` of its fields (the hash strings
    as unicode arrays, ``mem_apps`` as [A, 2]), as
    :data:`BENCHMARK_TABLES_FILE` stores them."""
    with np.load(path) as z:
        strs = {k: tuple(str(s) for s in z[k])
                for k in ("owners", "apps", "funcs", "triggers")}
        return AzureTables(
            **strs, counts=z["counts"], dur_pcts=z["dur_pcts"],
            mem_apps=tuple((str(o), str(a)) for o, a in z["mem_apps"]),
            mem_pcts=z["mem_pcts"])


def benchmark_replay_tables() -> AzureTables:
    """The vertical benchmark's tables, from :data:`BENCHMARK_TABLES_FILE`
    (the same under every numpy)."""
    return _load_tables(BENCHMARK_TABLES_FILE)


def benchmark_replay_trace() -> Trace:
    """The vertical benchmark's replay trace, loaded from
    :data:`BENCHMARK_REPLAY_FILE` (the same arrays under every numpy;
    ``trace_from_tables(benchmark_replay_tables())``)."""
    with np.load(BENCHMARK_REPLAY_FILE) as z:
        return Trace(t=z["t"], func_id=z["func_id"], size_mb=z["size_mb"],
                     cls=z["cls"], warm_dur=z["warm_dur"],
                     cold_dur=z["cold_dur"])
