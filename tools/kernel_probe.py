#!/usr/bin/env python3
"""Hold the Cholesky, fused-factor and triangular-solve CUDA kernels of this
checkout against an earlier checkout's on one GPU: the same results bit for
bit, and their times in turns.

    python3 tools/kernel_probe.py --parent DIR [--out FILE]

DIR is an earlier checkout, e.g. unpacked with
``git archive <rev> spatial_alignment_tpu_torch/csrc | tar -x -C DIR``.
Builds both checkouts' csrc/{cholesky,factor,trisolve}.cu with the flags of
``spatial_alignment_tpu_torch/ops/_build.py`` and runs them on the same
inputs at the shapes of the fits' paths. It raises when the two differ in
any bit: these kernels' rounding is part of their contract (the header of
csrc/common.cuh). Then it times each in turns (parent, this, this, parent)
by ``chip_smoke.median_ms`` (device time per call, the host's issue time
left out), beside the PyTorch library call for the same function. One JSON
object goes to stdout and to FILE (default
spatial_alignment_tpu_torch/_build/kernel_probe.json). Needs a CUDA device
and nvcc; exits 2 without a device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCES = ("cholesky", "factor", "trisolve")
TAGS = ("parent", "this")
# Shapes on the fits' paths: the m = 200 final slab and jitter probe (two
# rungs stacked), the 100k fit's m = 100 pair, the m = 50 pair, and the
# global-memory variant (m = 256, off the paths).
CHOL_SHAPES = [(14, 200, 200), (4, 200, 200), (14, 100, 100), (4, 100, 100), (34, 50, 50),
               (2, 50, 50), (2, 256, 256)]
FACTOR_SHAPES = [(14, 200, 200), (34, 50, 50)]
# (L shape, B shape, trans); B None is the identity right-hand side (L^-1).
SOLVES = [((1, 200, 200), (1, 200, 2), False), ((1, 200, 200), (1, 200, 2), True),
          ((200, 200), (200, 10), False), ((200, 200), (200, 10), True),
          ((50, 50), (5, 50, 200), False), ((50, 50), (5, 50, 200), True),
          ((1, 50, 50), (1, 50, 100), False), ((1, 50, 50), (1, 50, 100), True),
          ((2, 200, 200), None, False)]


def build(out_dir: Path, csrc: Path, name: str, tag: str):
    from spatial_alignment_tpu_torch.ops import _build

    out = out_dir / f"lib{name}-{tag}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(csrc / f"{name}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn, args in (("sat_cholesky_f32", [vp, vp, ll, i, vp]),
                     ("sat_factor_f32", [vp, vp, vp, ll, i, vp]),
                     ("sat_trisolve_f32", [vp, ll, vp, vp, ll, i, i, i, i, vp])):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="an earlier checkout to hold this one against")
    parser.add_argument("--out", type=Path,
                        default=ROOT / "spatial_alignment_tpu_torch" / "_build" / "kernel_probe.json")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import bit_equal, median_ms, nvidia_smi, spd

    out_dir = ROOT / "spatial_alignment_tpu_torch" / "_build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrcs = {"parent": args.parent / "spatial_alignment_tpu_torch" / "csrc",
             "this": ROOT / "spatial_alignment_tpu_torch" / "csrc"}
    jobs = {(t, name): build(out_dir, csrcs[t], name, t) for t in TAGS for name in SOURCES}
    libs = {}
    for key, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = bind(path)

    dev = "cuda"
    stream = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def launched(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    def held(outs, what):
        """Raise unless the parent's outputs equal this checkout's bit for bit."""
        torch.cuda.synchronize()
        for a, b in zip(outs["parent"], outs["this"]):
            if not bit_equal(a, b):
                raise AssertionError(f"{what}: the parent's result differs from this checkout's")

    def in_turns(fns):
        """{name: [ms, ms]}: parent, this, this, parent, then the library twice."""
        times = {t: [] for t in fns}
        for t in ("parent", "this", "this", "parent", "library", "library"):
            times[t].append(median_ms(fns[t]))
        return times

    record = {"device": nvidia_smi(), "cholesky": [], "factor": [], "trisolve": []}
    for shape in CHOL_SHAPES:
        B, m = shape[0], shape[-1]
        A = spd(gen, B, m, dev)
        outs = {t: [torch.empty_like(A)] for t in TAGS}

        def run(t):
            return lambda: launched(libs[(t, "cholesky")].sat_cholesky_f32(
                A.data_ptr(), outs[t][0].data_ptr(), B, m, stream()), f"cholesky {t}")

        fns = {t: run(t) for t in TAGS}
        for f in fns.values():
            f()
        held(outs, f"cholesky {shape}")
        fns["library"] = lambda: torch.linalg.cholesky(A)
        record["cholesky"].append({"shape": list(shape), "ms": in_turns(fns)})

    for shape in FACTOR_SHAPES:
        B, m = shape[0], shape[-1]
        A = spd(gen, B, m, dev)
        outs = {t: [torch.empty_like(A), torch.empty_like(A)] for t in TAGS}

        def run(t):
            return lambda: launched(libs[(t, "factor")].sat_factor_f32(
                A.data_ptr(), outs[t][0].data_ptr(), outs[t][1].data_ptr(), B, m, stream()),
                f"factor {t}")

        fns = {t: run(t) for t in TAGS}
        for f in fns.values():
            f()
        held(outs, f"factor {shape}")

        def chain():
            Lc, _ = torch.linalg.cholesky_ex(A)
            eye = torch.eye(m, device=dev).expand(A.shape)
            return torch.linalg.solve_triangular(Lc, eye, upper=False)

        fns["library"] = chain
        record["factor"].append({"shape": list(shape), "ms": in_turns(fns)})

    for l_shape, b_shape, trans in SOLVES:
        m = l_shape[-1]
        nf = 1 if len(l_shape) == 2 else l_shape[0]
        L = torch.linalg.cholesky(spd(gen, nf, m, dev)).reshape(l_shape).contiguous()
        ident = b_shape is None
        Bm = None if ident else torch.randn(b_shape, generator=gen, device=dev)
        shared = len(l_shape) == 2 and not ident and len(b_shape) == 3
        batch = b_shape[0] if (not ident and len(b_shape) == 3) else nf
        n = m if ident else b_shape[-1]
        outs = {t: [torch.empty((batch, m, n), device=dev)] for t in TAGS}

        def run(t):
            return lambda: launched(libs[(t, "trisolve")].sat_trisolve_f32(
                L.data_ptr(), 0 if shared else m * m, 0 if ident else Bm.data_ptr(),
                outs[t][0].data_ptr(), batch, m, n, int(trans), int(ident), stream()),
                f"trisolve {t}")

        fns = {t: run(t) for t in TAGS}
        for f in fns.values():
            f()
        held(outs, f"trisolve L {l_shape} B {b_shape} trans {trans}")
        Lb = L.expand((batch, m, m)) if shared else L.reshape(batch, m, m)
        rhs = torch.eye(m, device=dev).expand(Lb.shape) if ident else Bm.reshape(batch, m, n)
        op = Lb.transpose(-1, -2) if trans else Lb
        fns["library"] = lambda: torch.linalg.solve_triangular(op, rhs, upper=trans)
        record["trisolve"].append({"L": list(l_shape), "B": None if ident else list(b_shape),
                                   "trans": trans, "ms": in_turns(fns)})
    record["bit_equal_to_parent"] = True
    text = json.dumps(record)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
