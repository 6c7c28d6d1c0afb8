"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

A library may also be a second build of a source with macros of its own
(``VARIANTS``: ``quad_tf32`` is ``quad.cu`` built with
``-DSAT_QUAD_TF32_PASSES=1``, the quad kernels' one-pass TF32 mode). The
file name carries a hash of the source, of every shared header
(``csrc/*.cuh``) and of the variant's flags, so an edited source or header
never loads a stale library. The build happens at first use, inside the function that
launches a kernel; importing this module compiles nothing. ``build_all``
starts one nvcc per source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from ..utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("cholesky", "trisolve", "quad", "quad_tf32", "factor", "gram")
# Libraries built from another library's source: name -> (source, nvcc flags).
VARIANTS = {"quad_tf32": ("quad", ("-DSAT_QUAD_TF32_PASSES=1",))}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
        "port's CUDA kernels are built from source at first use"
    )


def _source(name: str):
    """(source file, extra nvcc flags) of library ``name``."""
    src, flags = VARIANTS.get(name, (name, ()))
    return CSRC / f"{src}.cu", flags


def library_path(name: str) -> Path:
    src, flags = _source(name)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, verbose: bool):
    """Start nvcc for one source; None when its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    src, extra = _source(name)
    flags = [*NVCC_FLAGS, *extra, *(("-Xptxas", "-v") if verbose else ())]
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return name, proc, tmp, out, cmd


def build_all(names: Iterable[str] = SOURCES, verbose: bool = False):
    """Compile every missing library, one nvcc per source, in parallel.

    Returns (wall seconds, {name: compiler output}); ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel).
    Raises if any build fails.
    """
    t0 = time.perf_counter()
    jobs = [j for j in (_start(n, verbose) for n in names) if j is not None]
    logs, failures = {}, []
    for name, proc, tmp, out, cmd in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``csrc/<name>.cu`` or a ``VARIANTS``
    build), building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with profiling.span("gpsa.ops.build"):
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
