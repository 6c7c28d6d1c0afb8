#!/usr/bin/env python3
"""Hold the Cholesky, fused-factor, triangular-solve, quad-diag and
cross-Gram CUDA kernels of this checkout against an earlier checkout's on
one GPU: the same results bit for bit (where a quad design changed: each
against float64 within its error bound), and their times in turns.

    python3 tools/kernel_probe.py --parent DIR [--kernels LIST] [--out FILE]

DIR is an earlier checkout, e.g. unpacked with
``git archive <rev> spatial_alignment_tpu_torch/csrc | tar -x -C DIR``.
Builds both checkouts' csrc/{cholesky,factor,trisolve,quad,gram}.cu (those
LIST names: cholesky, factor, trisolve, quad_bwd, gram; default all), and
quad.cu's one-pass TF32 build (``quad_tf32``), with the flags of
``spatial_alignment_tpu_torch/ops/_build.py`` and runs them on the same
inputs at the shapes of the fits' paths. It raises when the two Cholesky,
factor, solve or Gram results differ in any bit: these kernels' rounding is
part of their contract (the headers of csrc/common.cuh and csrc/gram.cu);
only the fused factor's L^-1 above m = 240, which the panel design rounds
as the shared-memory design does, is held to the plain version (rel 1e-4).
The quad backward (and, in the one-pass build, the forward) of each
checkout is held to its plain version in the 3xTF32 build (rel 1e-4) and to
float64 within ``chip_smoke.error_bounds`` (TF32) in the one-pass build,
and bit for bit to the earlier checkout's where this checkout runs the same
design: the 3xTF32 build everywhere, the one-pass build at m = 50 and above
m = 256 (not where it runs the warpgroup-MMA design, m <= 256, m % 4 == 0).
This checkout's quad kernels are launched twice and held bit-equal. Then it
times each in turns (parent, this, this, parent) by
``chip_smoke.median_ms`` (device time per call, the host's issue time left
out), beside the PyTorch library call for the same function (the Gram: the
expansion form, the quad backward: its plain version). The Gram rows also
time an empty kernel, the floor of a launch. One JSON object goes to stdout and to FILE (default
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

SOURCES = ("cholesky", "factor", "trisolve", "quad", "quad_tf32", "gram")
KERNELS = ("cholesky", "factor", "trisolve", "quad_bwd", "gram")
TAGS = ("parent", "this")
# Shapes on the fits' paths: the m = 200 and m = 384 final slabs and jitter
# probes (two rungs stacked), the 100k fit's m = 100 pair, the m = 50 pair,
# and the panel design at (2, 256, 256) and (4, 512, 512).
CHOL_SHAPES = [(14, 200, 200), (4, 200, 200), (14, 100, 100), (4, 100, 100), (34, 50, 50),
               (2, 50, 50), (2, 256, 256), (14, 384, 384), (4, 384, 384), (4, 512, 512)]
FACTOR_SHAPES = [(14, 200, 200), (34, 50, 50), (4, 256, 256), (14, 384, 384)]
# (L shape, B shape, trans); B None is the identity right-hand side (L^-1).
SOLVES = [((1, 200, 200), (1, 200, 2), False), ((1, 200, 200), (1, 200, 2), True),
          ((200, 200), (200, 10), False), ((200, 200), (200, 10), True),
          ((50, 50), (5, 50, 200), False), ((50, 50), (5, 50, 200), True),
          ((1, 50, 50), (1, 50, 100), False), ((1, 50, 50), (1, 50, 100), True),
          ((2, 200, 200), None, False)]
# Quad-diag (x shape, F shape): the m = 200 fit's data and warp layers, the
# m = 50 fit's, the m = 384 fit's, and the m = 384 ones at m = 512, the
# widest m of the tensor-core design (off the paths). The backward runs at
# all of them in both builds, the forward in the one-pass build at the
# m = 200 and m = 50 ones.
QUAD_BWD = [((5, 4050, 200), (10, 200, 200)), ((1, 2025, 200), (1, 2, 200, 200)),
            ((5, 200, 50), (30, 50, 50)), ((1, 100, 50), (1, 2, 50, 50)),
            ((5, 4050, 384), (10, 384, 384)), ((1, 2025, 384), (1, 2, 384, 384)),
            ((5, 4050, 512), (10, 512, 512)), ((1, 2025, 512), (1, 2, 512, 512))]
# Cross-Gram (x1 shape, x2 shape, per-group parameters): the 100k fit's warp
# layer, data layer, data layer in chunks of 2,048, and predict()'s warp
# and data layers.
GRAMS = [((1, 100, 2), (1, 4096, 2), True), ((100, 2), (5, 8192, 2), False),
         ((100, 2), (5, 2048, 2), False), ((1, 100, 2), (1, 50000, 2), True),
         ((100, 2), (1, 6250, 2), False)]
GRAM_KINDS = ("rbf", "matern12", "matern32")


def build(out_dir: Path, csrc: Path, name: str, tag: str):
    from spatial_alignment_tpu_torch.ops import _build

    out = out_dir / f"lib{name}-{tag}.so"
    source, flags = _build.VARIANTS.get(name, (name, ()))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
           str(csrc / f"{source}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # Since the panel design the Cholesky and factor entries take a scratch
    # pointer after their outputs (null while the panels fit shared memory).
    scratch = [vp] if hasattr(lib, "sat_cholesky_scratch_floats") or hasattr(
        lib, "sat_factor_scratch_floats") else []
    for fn, args in (("sat_cholesky_f32", [vp, vp, *scratch, ll, i, vp]),
                     ("sat_factor_f32", [vp, vp, vp, *scratch, ll, i, vp]),
                     ("sat_trisolve_f32", [vp, ll, vp, vp, ll, i, i, i, i, vp]),
                     ("sat_quad_bwd_splits", [i, i, i, i, i]),
                     ("sat_quad_bwd_design", [i, i, i, i, i, ctypes.POINTER(ll)])):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i
    if hasattr(lib, "sat_gram_f32"):
        lib.sat_gram_f32.argtypes = [vp, ll, vp, ll, vp, i, vp, i, vp, i, i, i, i, i, i, vp]
        lib.sat_gram_f32.restype = i
    if hasattr(lib, "sat_gram_row_splits"):  # since the even row split
        lib.sat_gram_row_splits.argtypes = [i, i, i]
        lib.sat_gram_row_splits.restype = ll
        lib.sat_empty_kernel.argtypes = [vp]
        lib.sat_empty_kernel.restype = i
    if hasattr(lib, "sat_quad_bwd_f32"):  # the first design's entry takes the splits
        first = hasattr(lib, "sat_quad_bwd_splits")
        lib.sat_quad_bwd_f32.argtypes = [vp, vp, ll, vp, vp, vp, vp, i, i, i, i, i,
                                         *([i] if first else []), vp]
        lib.sat_quad_bwd_f32.restype = i
    if hasattr(lib, "sat_quad_fwd_strided_f32"):  # a scratch pointer since the wgmma design
        scratch = hasattr(lib, "sat_quad_fwd_scratch_floats")
        lib.sat_quad_fwd_strided_f32.argtypes = [vp, ll, ll, ll, vp, ll, vp,
                                                 *([vp] if scratch else []), i, i, i, i, vp]
        lib.sat_quad_fwd_strided_f32.restype = i
        if scratch:
            lib.sat_quad_fwd_scratch_floats.argtypes = [i, i, i, i, i]
            lib.sat_quad_fwd_scratch_floats.restype = ll
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="an earlier checkout to hold this one against")
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help=f"comma-separated subset of {','.join(KERNELS)}")
    parser.add_argument("--out", type=Path,
                        default=ROOT / "spatial_alignment_tpu_torch" / "_build" / "kernel_probe.json")
    args = parser.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        parser.error(f"--kernels takes {','.join(KERNELS)}")
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import bit_equal, median_ms, nvidia_smi, rel_err, spd

    out_dir = ROOT / "spatial_alignment_tpu_torch" / "_build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrcs = {"parent": args.parent / "spatial_alignment_tpu_torch" / "csrc",
             "this": ROOT / "spatial_alignment_tpu_torch" / "csrc"}
    names = [n for n in SOURCES if (n if not n.startswith("quad") else "quad_bwd") in kernels]
    jobs = {(t, name): build(out_dir, csrcs[t], name, t) for t in TAGS for name in names}
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

    keep = []  # scratch buffers, alive while their launches run

    def scratch(lib, query, B, m):
        """A device pointer to the scratch the entry needs (0 when none)."""
        fn = getattr(lib, query)
        fn.argtypes, fn.restype = [ctypes.c_longlong, ctypes.c_int], ctypes.c_longlong
        n = fn(B, m)
        if n <= 0:
            return 0
        keep.append(torch.empty(n, device=dev))
        return keep[-1].data_ptr()

    record = {"device": nvidia_smi(), "cholesky": [], "factor": [], "trisolve": []}
    for shape in CHOL_SHAPES if "cholesky" in kernels else ():
        B, m = shape[0], shape[-1]
        A = spd(gen, B, m, dev)
        outs = {t: [torch.empty_like(A)] for t in TAGS}

        def run(t):
            lib = libs[(t, "cholesky")]
            extra = (scratch(lib, "sat_cholesky_scratch_floats", B, m),) if hasattr(
                lib, "sat_cholesky_scratch_floats") else ()
            return lambda: launched(lib.sat_cholesky_f32(
                A.data_ptr(), outs[t][0].data_ptr(), *extra, B, m, stream()), f"cholesky {t}")

        fns = {t: run(t) for t in TAGS}
        for f in fns.values():
            f()
        held(outs, f"cholesky {shape}")
        fns["library"] = lambda: torch.linalg.cholesky(A)
        record["cholesky"].append({"shape": list(shape), "ms": in_turns(fns)})

    for shape in FACTOR_SHAPES if "factor" in kernels else ():
        B, m = shape[0], shape[-1]
        A = spd(gen, B, m, dev)
        outs = {t: [torch.empty_like(A), torch.empty_like(A)] for t in TAGS}

        def run(t):
            lib = libs[(t, "factor")]
            extra = (scratch(lib, "sat_factor_scratch_floats", B, m),) if hasattr(
                lib, "sat_factor_scratch_floats") else ()
            return lambda: launched(lib.sat_factor_f32(
                A.data_ptr(), outs[t][0].data_ptr(), outs[t][1].data_ptr(), *extra, B, m,
                stream()), f"factor {t}")

        fns = {t: run(t) for t in TAGS}
        for f in fns.values():
            f()
        if m <= 240:
            held(outs, f"factor {shape}")
        else:
            # Above 240 the panel design's inverse rounds otherwise than the
            # first design's (it multiplies by 1 / L_ii and by W_KK, as the
            # shared-memory design does): L bit for bit, each L^-1 within
            # rel 1e-4 of the plain version's.
            held({t: outs[t][:1] for t in TAGS}, f"factor {shape}")
            eye = torch.eye(m, device=dev).expand(A.shape)
            Wp = torch.linalg.solve_triangular(torch.linalg.cholesky(A), eye, upper=False)
            for t in TAGS:
                if rel_err(outs[t][1], Wp) > 1e-4:
                    raise AssertionError(f"factor {shape} {t}: L^-1 rel {rel_err(outs[t][1], Wp)}")

        def chain():
            Lc, _ = torch.linalg.cholesky_ex(A)
            eye = torch.eye(m, device=dev).expand(A.shape)
            return torch.linalg.solve_triangular(Lc, eye, upper=False)

        fns["library"] = chain
        record["factor"].append({"shape": list(shape), "ms": in_turns(fns)})

    for l_shape, b_shape, trans in SOLVES if "trisolve" in kernels else ():
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
    if "quad_bwd" in kernels:
        record["quad_bwd"] = probe_quad_bwd(libs, gen, stream, launched, held, in_turns)
    if "gram" in kernels:
        record["gram"] = probe_gram(libs, gen, stream, launched, held, in_turns)
    record["bit_equal_to_parent"] = [k for k in ("cholesky", "factor", "trisolve", "gram")
                                     if k in kernels] + (
        ["quad 3xTF32", "quad one-pass where the design is unchanged"]
        if "quad_bwd" in kernels else [])
    text = json.dumps(record)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


def probe_quad_bwd(libs, gen, stream, launched, held, in_turns):
    """Each checkout's quad backward in both builds, and forward in the
    one-pass build, at the fits' shapes: held against the plain version
    (3xTF32) or float64 within the TF32 bound (one pass), this checkout's
    launched twice and held bit-equal, and held bit for bit to the parent's
    where this checkout runs the parent's design; then both timed in turns
    (no library call computes them)."""
    import torch
    from chip_smoke import bit_equal, error_bounds, rel_err
    from spatial_alignment_tpu_torch.ops import quad

    rows = []
    keep = []
    for build, name in (("quad", "3xtf32"), ("quad_tf32", "tf32")):
        for x_shape, f_shape in QUAD_BWD:
            G, N, m = x_shape
            L = f_shape[-3]
            n_groups = G if len(f_shape) == 4 else 1
            x = torch.randn(x_shape, generator=gen, device="cuda")
            F = 0.1 * torch.randn(f_shape, generator=gen, device="cuda")
            dy = torch.randn((G, L, N), generator=gen, device="cuda")
            fg = L * m * m if n_groups > 1 else 0
            forward = build == "quad_tf32" and m in (50, 200)

            def design_of(lib, what):
                d = (ctypes.c_longlong * 16)()  # 8 values before the paired-warp design, 11, then 12
                launched(lib.sat_quad_bwd_design(G, N, m, L, n_groups, d), f"design {what}")
                return list(d)[:12]

            def runner(t):
                lib = libs[(t, build)]
                design = design_of(lib, t)
                dx, dF = torch.empty_like(x), torch.empty_like(F)
                scratch = torch.empty((design[7],), device="cuda")
                out = torch.empty((G, L, N), device="cuda")
                fscratch = []
                if hasattr(lib, "sat_quad_fwd_scratch_floats"):
                    n = lib.sat_quad_fwd_scratch_floats(G, N, m, L, int(n_groups > 1))
                    keep.append(torch.empty((max(n, 1),), device="cuda"))
                    fscratch = [keep[-1].data_ptr()]
                keep.append(scratch)

                def bwd():
                    launched(lib.sat_quad_bwd_f32(
                        x.data_ptr(), F.data_ptr(), fg, dy.data_ptr(), dx.data_ptr(),
                        dF.data_ptr(), scratch.data_ptr(), G, N, m, L, n_groups, stream()),
                        f"quad_bwd {t}")

                def fwd():
                    launched(lib.sat_quad_fwd_strided_f32(
                        x.data_ptr(), N * m, m, 1, F.data_ptr(), fg, out.data_ptr(), *fscratch,
                        G, N, m, L, stream()), f"quad_fwd {t}")
                return bwd, fwd, (dx, dF), out, design

            precision = "highest" if build == "quad" else "default"
            plain = quad.quad_bwd_plain(x, F, dy, precision)
            bounds = error_bounds(x, F, dy, "tf32") if build == "quad_tf32" else None
            this_design = design_of(libs[("this", build)], "this")
            same_design = build == "quad" or not this_design[11]
            fns, ffns, errs, outs, fouts = {}, {}, {}, {}, {}
            for t in TAGS:
                bwd, fwd, grads, out, design = runner(t)
                bwd()
                if forward:
                    fwd()
                torch.cuda.synchronize()
                if bounds is None:
                    errs[t] = max(rel_err(g, p) for g, p in zip(grads, plain))
                    if errs[t] > 1e-4:
                        raise AssertionError(f"quad_bwd {t} {x_shape}: rel {errs[t]} to plain")
                else:  # the error over its bound, each output of the backward (and forward)
                    got = ((out,) if forward else ()) + grads
                    bnd = bounds if forward else bounds[1:]
                    errs[t] = max(float(((k.double() - e).abs() / b).max())
                                  for k, (e, b) in zip(got, bnd))
                    if errs[t] > 1.0:
                        raise AssertionError(f"quad {name} {t} {x_shape}: {errs[t]} of the bound")
                if t == "this":
                    first = [g.clone() for g in grads] + [out.clone()]
                    bwd()
                    if forward:
                        fwd()
                    torch.cuda.synchronize()
                    if not all(bit_equal(a, b) for a, b in zip(first, [*grads, out])):
                        raise AssertionError(f"quad {name} {x_shape}: two launches differ")
                fns[t], ffns[t], outs[t], fouts[t] = bwd, fwd, grads, [out]
            if same_design:
                held(outs, f"quad_bwd {name} {x_shape}")
                if forward:
                    held(fouts, f"quad_fwd {name} {x_shape}")
            fns["library"] = lambda: quad.quad_bwd_plain(x, F, dy, precision)
            row = {"build": name, "x": list(x_shape), "F": list(f_shape),
                   ("rel_vs_plain" if bounds is None else "err_over_bound"): errs,
                   "design_this": this_design, "bit_equal_twice": True,
                   "bit_equal_to_parent": same_design, "ms": in_turns(fns),
                   "library_is": "quad_bwd_plain (no library call)"}
            if forward:
                ffns["library"] = lambda: quad.quad_diag_plain(x, F, precision)
                row["fwd_ms"] = in_turns(ffns)
            rows.append(row)
    return rows


def probe_gram(libs, gen, stream, launched, held, in_turns):
    """Both checkouts' Gram kernels at the 100k path's shapes, every kind,
    float32 (and at one shape bfloat16) held bit for bit, timed in turns
    beside the expansion form; an empty kernel, the floor of a launch."""
    import torch
    from chip_smoke import median_ms
    from spatial_alignment_tpu_torch.ops import gram as gm

    this = libs[("this", "gram")]
    rows = []
    empty_ms = median_ms(lambda: launched(this.sat_empty_kernel(stream()), "empty kernel"))
    for x1_shape, x2_shape, per_group in GRAMS:
        x1 = 10 * torch.rand(x1_shape, generator=gen, device="cuda")
        x2 = 10 * torch.rand(x2_shape, generator=gen, device="cuda")
        n_par = x2_shape[0] if per_group else 1
        ls = 1.5 * torch.rand((n_par,), generator=gen, device="cuda") - 0.5
        var = torch.rand((n_par,), generator=gen, device="cuda") - 0.5
        G = x2_shape[0] if len(x2_shape) == 3 else 1
        M, N, D = x1_shape[-2], x2_shape[-2], x2_shape[-1]
        x1_stride = M * D if len(x1_shape) == 3 else 0
        x2_stride = N * D if len(x2_shape) == 3 else 0
        auto = this.sat_gram_row_splits(G, M, N)
        for kind in GRAM_KINDS:
            for bf16 in ((False, True) if x2_shape == (5, 2048, 2) else (False,)):
                dtype = torch.bfloat16 if bf16 else torch.float32
                outs = {t: [torch.empty((G, M, N), dtype=dtype, device="cuda")] for t in TAGS}

                def run(t):
                    lib = libs[(t, "gram")]
                    return lambda: launched(lib.sat_gram_f32(
                        x1.data_ptr(), x1_stride, x2.data_ptr(), x2_stride, ls.data_ptr(),
                        int(per_group), var.data_ptr(), int(per_group), outs[t][0].data_ptr(),
                        int(bf16), G, M, N, D, GRAM_KINDS.index(kind), stream()),
                        f"gram {t}")

                fns = {t: run(t) for t in TAGS}
                for f in fns.values():
                    f()
                held(outs, f"gram {kind} {x2_shape} {dtype}")
                fns["library"] = lambda: gm.gram(x1, x2, ls, var, kind, force=False)
                rows.append({"x1": list(x1_shape), "x2": list(x2_shape), "kind": kind,
                             "dtype": str(dtype), "bit_equal_to_parent": True,
                             "row_splits": auto, "ms": in_turns(fns),
                             "library_is": "expansion form (gram, force=False)",
                             "empty_kernel_ms": empty_ms})
    return rows


if __name__ == "__main__":
    sys.exit(main())
