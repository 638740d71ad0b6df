"""Multi-pod dry-run: trace every (architecture x input shape) on the
production meshes and record its terms; port of ``repro.launch.dryrun``.

For each combination this:
  1. sets up torch's fake process group of 256 (or 512) ranks in this
     one process where no group is up (its collectives move nothing),
     and builds the 16x16 (or 2x16x16) ``DeviceMesh`` on it
     (``make_production_mesh``);
  2. builds the sharded step (``make_step_for``: train / prefill /
     decode) and places its example arguments, ``meta`` tensors, on the
     mesh under the step's specs: rank 0's local shards, as ``DTensor``s;
  3. runs the step on them.  A ``meta`` tensor holds no data: nothing is
     allocated and no kernel launches (``kernels.ops.tracing_shapes``:
     the plain versions, which only carry shapes), so this is the one
     entry point of the port that needs no card, as the reference's
     dry-run is a host tool.  A sharding mismatch, a refused split (an
     MoE routing group cut by the data axes) or an op that needs data
     raises here;
  4. records the per-rank terms below into a JSON report.

What each key of the record measures here (the reference's keys):

* ``arch``, ``shape``, ``mesh``, ``chips``, ``notes``, ``n_layers``,
  ``params``, ``active_params``, ``optimized``: as the reference's.
* ``flops``: per rank, ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the step's matmuls and attention on this rank's rows (the
  plain versions' ops: attention counts every masked score it computes).
* ``bytes_accessed``: per rank, the bytes that every op of the step
  (views excepted) reads and writes, each op's inputs and outputs once:
  no fusion is assumed.
* ``collectives``: ``{all-gather, all-reduce, reduce-scatter,
  all-to-all, collective-permute: {count, bytes}, total_bytes}``, each
  collective the step issues on this rank with the bytes of its result,
  from the port's tally of the ``c10d`` ops (``collective_stats``).
  The steps issue no all-to-all and torch has no collective-permute:
  those stay 0.
* ``argument_size_in_bytes`` / ``output_size_in_bytes``: the bytes of
  this rank's local shards of the step's arguments / results.
* ``trace_s``: seconds to build and run the step, in place of the
  reference's ``lower_s`` and ``compile_s``.
* ``totals_exact``: true for every family, since the port traces every
  layer (the reference's XLA counts a loop body once), so
  ``total_flops``, ``total_bytes_accessed`` and
  ``total_collective_bytes`` are the raw terms, and ``--roofline`` (the
  reference's L = 0 / L = 2 correction) has nothing to correct.

``temp_size_in_bytes`` and ``generated_code_size_in_bytes`` are the
compiler's and have no counterpart: they are left out.

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k \\
      --mesh both
  python -m repro_torch.launch.dryrun --all --mesh single \\
      --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
#: Fragments of the ``c10d`` and ``_c10d_functional`` op names, by the
#: collective each names.
_KINDS = (("reduce_scatter", "reduce-scatter"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))


def _kind(op: str) -> str | None:
    name = op.split(".")[-2] if op.count(".") >= 2 else op
    return next((k for frag, k in _KINDS if frag in name), None)


def collective_stats(ops) -> dict:
    """Count and sum the result bytes of each collective in ``ops``, the
    port's record of the collectives a step issued: ``(op name, bytes)``
    pairs, the names ``torch.ops`` gives (``c10d.allreduce_.default``,
    ``_c10d_functional.all_gather_into_tensor.default``)."""
    stats: dict[str, dict] = {c: {"count": 0, "bytes": 0}
                              for c in _COLLECTIVES}
    for op, nbytes in ops:
        kind = _kind(op)
        if kind is not None:
            stats[kind]["count"] += 1
            stats[kind]["bytes"] += int(nbytes)
    stats["total_bytes"] = sum(v["bytes"] for k, v in stats.items()
                               if isinstance(v, dict))
    return stats


def _nbytes(x) -> int:
    """Bytes of the plain tensors in ``x`` (a tensor or a list of them);
    a ``DTensor`` counts its local shard."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    if isinstance(x, DTensor):
        x = x.to_local()
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _tally_mode():
    """A dispatch mode that records each collective op with its result
    bytes (``.ops``) and sums every other op's input and output bytes
    (``.bytes_accessed``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Tally(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.bytes_accessed = [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if func.namespace in ("c10d", "_c10d_functional"):
                if _kind(name) is not None:
                    # c10d's ops work in place on their first argument
                    res = args[0] if func.namespace == "c10d" else out
                    self.ops.append((name, _nbytes(res)))
            elif not func.is_view:
                self.bytes_accessed += sum(
                    _nbytes(t) for t in tree_leaves((args, kwargs, out)))
            return out

    return Tally()


def _placed_args(cfg, shape, mesh, optimize: bool, args) -> tuple:
    """The step's example args as ``DTensor``s of rank 0's local shards
    under the specs the step places them under."""
    from .._tree import map_with_keys
    from ..models.sharding import (batch_specs, cache_specs,
                                   opt_state_specs, param_specs)
    from .steps import _place, _table

    def on_mesh(tree, specs):
        tab = _table(mesh, specs)
        return map_with_keys(tree, lambda k, x: _place(x, mesh, tab[k]))

    mode = "train" if shape.kind == "train" else "serve"
    pshapes, *rest = args
    pspecs = param_specs(cfg, pshapes, mesh, mode)
    out = [on_mesh(pshapes, pspecs)]
    if shape.kind == "train":
        oshapes, bshapes = rest
        out.append(on_mesh(oshapes, opt_state_specs(pspecs, oshapes,
                                                    pshapes, mesh)))
    else:
        bshapes = rest[0]
    out.append(on_mesh(bshapes, batch_specs(cfg, bshapes, mesh)))
    if shape.kind == "decode":
        cshapes = rest[1]
        out.append(on_mesh(cshapes, cache_specs(cfg, cshapes, mesh,
                                                seq_shard=optimize)))
    return tuple(out)


def _trace_and_measure(cfg, shape, mesh, optimize: bool = False) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    from .._tree import tree_leaves
    from ..kernels.ops import tracing_shapes
    from .steps import make_step_for

    t0 = time.perf_counter()
    fn, example_args = make_step_for(cfg, mesh, shape, optimize=optimize)
    placed = _placed_args(cfg, shape, mesh, optimize, example_args)
    flops = FlopCounterMode(display=False)
    with flops, _tally_mode() as tally, tracing_shapes():
        out = fn(*placed)
    rec = {"trace_s": round(time.perf_counter() - t0, 2),
           "argument_size_in_bytes": sum(map(_nbytes, tree_leaves(placed))),
           "output_size_in_bytes": sum(map(_nbytes, tree_leaves(out))),
           "flops": float(flops.get_total_flops()),
           "bytes_accessed": float(tally.bytes_accessed),
           "collectives": collective_stats(tally.ops)}
    return rec


def run_one(arch: str, shape_name: str, multi_pod: bool, *,
            roofline: bool = False, optimize: bool = False) -> dict:
    """Trace the full config on the production mesh under torch's fake
    process group: set up here where no group is up and destroyed on the
    way out; a group of another size refuses the run.  ``roofline`` is
    accepted for the reference's call and changes nothing: the port's
    totals are exact for every family."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..configs import get_config
    from ..models import partitioning
    from ..models.config import INPUT_SHAPES
    from .mesh import (CHIPS_MULTI_POD, CHIPS_SINGLE_POD,
                       make_production_mesh)
    from .specs import describe

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    world = CHIPS_MULTI_POD if multi_pod else CHIPS_SINGLE_POD
    own = not dist.is_initialized()
    if not own and dist.get_world_size() != world:
        raise RuntimeError(
            f"the dry-run needs a process group of {world} ranks (or none, "
            f"to set up its fake one); one of {dist.get_world_size()} is up")
    if own:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        rec: dict = {
            "arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "chips": world,
            "notes": describe(cfg, shape),
            "n_layers": cfg.n_layers,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "optimized": optimize,
        }
        rec.update(_trace_and_measure(cfg, shape, mesh, optimize))
    finally:
        partitioning.disable()
        if own:
            dist.destroy_process_group()
    rec["totals_exact"] = True
    rec["total_flops"] = rec["flops"]
    rec["total_bytes_accessed"] = rec["bytes_accessed"]
    rec["total_collective_bytes"] = rec["collectives"]["total_bytes"]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="accepted for the reference's CLI; the port's "
                    "totals are exact without it")
    ap.add_argument("--opt", action="store_true",
                    help="enable the activation sharding constraints")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..configs import ARCH_IDS
    from ..models.config import INPUT_SHAPES

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records = []
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if multi else '16x16'}"
                try:
                    rec = run_one(arch, shape, multi,
                                  roofline=args.roofline,
                                  optimize=args.opt)
                    coll = rec["collectives"]["total_bytes"]
                    print(f"[ok] {tag}: trace={rec['trace_s']}s "
                          f"flops={rec['flops']:.3e} "
                          f"coll_bytes={coll:.3e}", flush=True)
                    records.append(rec)
                except Exception as e:
                    failures += 1
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
                    records.append({"arch": arch, "shape": shape,
                                    "mesh": "2x16x16" if multi else "16x16",
                                    "error": str(e)})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        # replace records with the same key
        key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
        merged = {key(r): r for r in existing}
        merged.update({key(r): r for r in records})
        with open(args.out, "w") as f:
            json.dump(list(merged.values()), f, indent=1)
        print(f"wrote {args.out} ({len(merged)} records)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
