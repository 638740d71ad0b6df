"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds into ``build/kernels/lib<name>.so`` under
the repository root (listed in ``.gitignore``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/kernels/lib<name>.so <name>.cu

``-fmad=false`` (and no fast math) keeps every float operation as
written, which B1's bitwise contract relies on; those are the default
flags.  A kernel with no bitwise contract passes its own,
:data:`ATTENTION_FLAGS`, which let ``nvcc`` contract into FMA: the
attention kernels (B2, B3) and the scans (B4, B5), which are held to
their plain versions within a tolerance, not bit for bit, and make no
decision on the values they compute.  A library
is built at first use in a process, and again whenever its source or a
header beside it (``csrc/*.cuh``) is newer; a failed build raises with
the compiler's output.
:func:`build_parallel` starts one ``nvcc`` per source at once.  Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
ATTENTION_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


@functools.cache
def build(name: str, flags: tuple[str, ...] = NVCC_FLAGS
          ) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` with ``flags`` if its library is missing
    or stale.

    Returns ``(library path, compiler output, seconds spent building)``;
    the output holds ``ptxas``'s register and shared-memory report."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    lib = BUILD_DIR / f"lib{name}.so"
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent build never sees half
    return lib, proc.stdout + proc.stderr, seconds


def build_parallel(jobs) -> list[tuple[Path, str, float]]:
    """:func:`build` each ``(name, flags)`` of ``jobs`` at once, one
    ``nvcc`` process each; results in the order of ``jobs``."""
    jobs = list(jobs)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return list(pool.map(lambda job: build(*job), jobs))


@functools.cache
def load(name: str, flags: tuple[str, ...] = NVCC_FLAGS) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, loaded once a process."""
    return ctypes.CDLL(str(build(name, flags)[0]))
