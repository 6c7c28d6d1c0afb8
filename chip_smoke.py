#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``spatial_alignment_tpu_torch`` (never the JAX package) through the
entry points a user calls, builds every CUDA kernel from the sources in the
checkout, and holds each kernel against its plain PyTorch version. Phases,
one JSON line each:

  device     nvidia-smi name and power limit, torch / CUDA versions, TF32 flags
  build      nvcc wall time, ptxas register / shared-memory report
  parity     tiny model: loss and gradients on the card vs the CPU path
  kernels    cholesky at every main-path shape, and at m = 256 (global-memory
             variant): error vs the plain version, reconstruction residual,
             NaN contract, autograd vs the plain path, median times
  fit_m200   the full-width slice: m = 200, N = 4,050, 10-latent LMC, 200 steps
  fit_m50    the m = 50 two-view grid, no LMC, 300 steps
  predict    predict() and forward(S=5) on the m = 200 model
  profile    (with --profile DIR) device time per step by kernel over 10
             steps of the m = 200 fit, the device's idle share, and the
             chrome trace in DIR

Every check raises on failure, so any failed phase exits non-zero. The last
two lines are the kernels summary and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or run from a directory without the package, it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks (dense, no sparsity) used for the bound: memory rate and
# float32 rate outside the tensor cores, by part.
_PEAKS = {
    "sxm": (3.35e12, 67e12),
    "pcie": (2.0e12, 51e12),
}


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n: int = 60, warmup: int = 5) -> float:
    """Median over ``n`` CUDA-event-timed calls of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def spd(gen, B, m, device):
    import torch

    a = torch.randn((B, m, m), generator=gen, device=device)
    return a @ a.transpose(-1, -2) / m + torch.eye(m, device=device)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def residual(L, A) -> float:
    import torch

    R = L.double() @ L.double().transpose(-1, -2) - A.double()
    return float(torch.linalg.matrix_norm(R).max() / torch.linalg.matrix_norm(A.double()).min())


def two_view_data(grid_size, n_latent, seed=0):
    import numpy as np
    from spatial_alignment_tpu_torch.data import generate_twod_data

    kw = dict(kernel_lengthscale=5.0, kernel_variance=0.5, noise_variance=0.001) if n_latent else {}
    X, Y, nsl, view_idx = generate_twod_data(
        2, 30, grid_size=grid_size, n_latent_gps=n_latent, fixed_view_idx=0,
        rng=np.random.default_rng(seed), **kw,
    )
    dd = {"expression": {"spatial_coords": X.astype(np.float32),
                         "outputs": Y.astype(np.float32), "n_samples_list": nsl}}
    return dd, X, view_idx


def aligned_error(coords, view_idx) -> float:
    import numpy as np

    return float(np.mean(np.sum((coords[view_idx[0]] - coords[view_idx[1]]) ** 2, axis=1)))


def capture_cholesky_inputs(model):
    """The inputs the main path hands the Cholesky in one loss evaluation
    (probe slab, then final slab), captured without changing the path."""
    import torch
    from spatial_alignment_tpu_torch.models import core
    from spatial_alignment_tpu_torch.ops import linalg

    captured, orig = [], linalg.cholesky

    def spy(a):
        captured.append(0.5 * (a.detach() + a.detach().transpose(-1, -2)))
        return orig(a)

    linalg.cholesky = spy
    try:
        with torch.no_grad():
            core.negative_elbo(model.spec, model.params, model.consts, model._batch, 5,
                               generator=model._gen)
    finally:
        linalg.cholesky = orig
    return captured


def phase_parity(device):
    """A tiny model's loss and gradients, on the card and on the CPU, from the
    same parameters and noise; the CPU path is what the test suite holds
    against the JAX package."""
    import numpy as np
    import torch
    from spatial_alignment_tpu_torch import VariationalGPSA
    from spatial_alignment_tpu_torch.models import core

    rng = np.random.default_rng(0)
    X1 = rng.uniform(0, 10, (40, 2)).astype(np.float32)
    X = np.concatenate([X1, X1 + 0.1 * rng.standard_normal(X1.shape).astype(np.float32)])
    Y = np.stack([np.sin(X[:, 0] * (j + 1) / 3.0) + np.cos(X[:, 1]) for j in range(3)], 1)
    dd = {"expression": {"spatial_coords": X, "outputs": Y.astype(np.float32),
                         "n_samples_list": [40, 40]}}
    kw = dict(m_X_per_view=16, m_G=16, n_latent_gps={"expression": 2}, fixed_view_idx=0)
    S = 3
    wn = torch.from_numpy(rng.standard_normal((S, 2, 40, 2)).astype(np.float32))
    dn = torch.from_numpy(rng.standard_normal((S, 80, 2)).astype(np.float32))
    out = {}
    for dev in ("cpu", device):
        m = VariationalGPSA(dd, device=dev, **kw)
        with torch.no_grad():  # moderate lengthscales keep the Grams well conditioned
            m.params["warp_kernel_lengthscales"].fill_(math.log(2.0))
            m.params["data_kernel_lengthscale"].fill_(math.log(2.0))
        loss = core.negative_elbo(m.spec, m.params, m.consts, m._batch, S,
                                  warp_noise=wn.to(dev), data_noise={"expression": dn.to(dev)})
        loss.backward()
        out[dev] = (float(loss.detach()), [p.grad.detach().cpu() for p in m.parameters()])
    (lc, gc), (lg, gg) = out["cpu"], out[device]
    loss_rel = abs(lc - lg) / abs(lc)
    grad_rel = max(rel_err(g, c) for g, c in zip(gg, gc) if c.abs().max() > 0)
    # 1e-4 on the loss and 1e-3 on gradients: f32 with other summation orders
    # and another Cholesky on each side.
    check(loss_rel <= 1e-4, f"card vs CPU loss rel {loss_rel}")
    check(grad_rel <= 1e-3, f"card vs CPU gradient rel {grad_rel}")
    emit("parity", loss_cpu=lc, loss_gpu=lg, loss_rel=loss_rel, max_grad_rel=grad_rel)


def phase_kernels(device, real_inputs, peaks):
    import torch
    from spatial_alignment_tpu_torch.ops import cholesky as ch

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    shapes = [(2, 50, 50), (34, 50, 50), (2, 2, 200, 200), (14, 200, 200), (2, 256, 256)]
    results = {}
    for shape in shapes:
        m = shape[-1]
        B = math.prod(shape[:-2])
        A = spd(gen, B, m, device).reshape(shape)
        Lk = ch.cholesky_kernel(A)
        Lp = ch.cholesky_plain(A)
        torch.cuda.synchronize()
        rel = rel_err(Lk, Lp)
        res = residual(Lk, A)
        upper_zero = bool((torch.triu(Lk, 1) == 0).all())
        # 1e-4 vs plain, 1e-5 residual: well-conditioned (cond < ~10) f32 input.
        check(rel <= 1e-4, f"cholesky {shape}: rel err vs plain {rel}")
        check(res <= 1e-5, f"cholesky {shape}: residual {res}")
        check(upper_zero, f"cholesky {shape}: nonzero above the diagonal")
        # Bound: each input byte read once, each output byte written once,
        # m^3/3 flops per matrix, against the part's published peaks.
        t_bytes = 2 * B * m * m * 4 / peaks[0] * 1e3
        t_ops = B * m**3 / 3 / peaks[1] * 1e3
        results[tuple(shape)] = {
            "shape": list(shape), "smem": ch.uses_shared_memory(m),
            "rel_vs_plain": rel, "residual": res, "max_abs_err": float((Lk - Lp).abs().max()),
            "kernel_ms": median_ms(lambda: ch.cholesky_kernel(A)),
            "plain_ms": median_ms(lambda: ch.cholesky_plain(A)),
            "library_ms": median_ms(lambda: torch.linalg.cholesky(A)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }

    # The real inputs of the m = 200 main path: near-singular kernel Grams
    # with their probe and final jitter.
    real = []
    for A in real_inputs:
        Lk, Lp = ch.cholesky_kernel(A), ch.cholesky_plain(A)
        torch.cuda.synchronize()
        nan_k = torch.isnan(Lk).flatten(-2).any(-1)
        nan_p = torch.isnan(Lp).flatten(-2).any(-1)
        check(bool((nan_k == nan_p).all()), f"real {tuple(A.shape)}: NaN lanes differ")
        ok = ~nan_k
        evals = torch.linalg.eigvalsh(A.double())
        cond = float((evals[..., -1] / evals[..., 0].abs()).max())
        rel = rel_err(Lk[ok], Lp[ok])
        res = residual(Lk[ok], A[ok])
        # Backward stability bounds the residual (1e-5, about m * 2^-24);
        # the factor itself may differ by up to ~cond * 2^-24 on Grams this
        # ill-conditioned, so rel is bounded by 10 * cond * 2^-24.
        check(res <= 1e-5, f"real {tuple(A.shape)}: residual {res}")
        check(rel <= max(1e-4, 10 * cond * 2.0**-24), f"real {tuple(A.shape)}: rel {rel} (cond {cond})")
        real.append({"shape": list(A.shape), "cond": cond, "rel_vs_plain": rel, "residual": res,
                     "max_abs_err": float((Lk[ok] - Lp[ok]).abs().max()),
                     "nan_lanes": int(nan_k.sum())})

    # NaN contract: an indefinite lane inside a batch.
    A = spd(gen, 4, 200, device)
    A[1] -= 3.0 * torch.eye(200, device=device)
    Lk = ch.cholesky_kernel(A)
    torch.cuda.synchronize()
    lower = torch.tril(torch.ones(200, 200, dtype=torch.bool, device=device))
    check(bool(torch.isnan(Lk[1][lower]).all()), "indefinite lane: lower triangle not all NaN")
    check(bool((Lk[1][~lower] == 0).all()), "indefinite lane: upper triangle not 0")
    others = Lk[[0, 2, 3]]
    check(bool(torch.isfinite(others).all()), "indefinite lane leaked into other lanes")
    check(rel_err(others, ch.cholesky_plain(A[[0, 2, 3]])) <= 1e-4, "other lanes differ")

    # Autograd: kernel forward + Murray backward on the card vs the plain
    # path on the CPU, same input and cotangent.
    A = spd(gen, 14, 200, device)
    W = torch.randn(A.shape, generator=gen, device=device)
    grads = []
    for dev in (device, "cpu"):
        a = A.detach().to(dev).clone().requires_grad_(True)
        (ch.cholesky(a) * W.to(dev)).sum().backward()
        grads.append(a.grad.cpu())
    grad_rel = rel_err(grads[0], grads[1])
    check(grad_rel <= 1e-3, f"cholesky gradient rel {grad_rel}")
    emit("kernels", cholesky={"random_spd": list(results.values()), "real_grams": real,
                              "nan_contract": "ok", "grad_rel_vs_plain": grad_rel})
    return results, real


def phase_fit(name, model, n_epochs, S, expect_mode):
    import numpy as np
    import torch
    from spatial_alignment_tpu_torch.ops import cholesky as ch

    check(model.spec.svgp_solve_mode == expect_mode,
          f"{name}: solve mode {model.spec.svgp_solve_mode}, expected {expect_mode}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ch.launches = 0
    ch.plain_calls = 0
    t0 = time.perf_counter()
    losses = model.fit(n_epochs=n_epochs, lr=1e-2, S=S)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain_calls = ch.launches, ch.plain_calls
    check(bool(np.isfinite(losses).all()), f"{name}: non-finite loss")
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[-50:]))
    check(last < first, f"{name}: loss did not fall ({first} -> {last})")
    check(launches == 2 * n_epochs, f"{name}: {launches} kernel launches for {n_epochs} steps")
    check(plain_calls == 0, f"{name}: plain cholesky called {plain_calls} times")
    emit(name, steps=n_epochs, seconds=dt, steps_per_s=n_epochs / dt,
         launches=launches, launches_per_step=launches / n_epochs, plain_calls=plain_calls,
         solve_mode=model.spec.svgp_solve_mode, loss_first50=first, loss_last50=last,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    return launches, dt / n_epochs


def phase_profile(model, step_s: float, out_dir: Path, steps: int = 10, S: int = 5,
                  top: int = 15):
    """Device time of ``steps`` training steps by kernel name, from
    torch.profiler, beside the unprofiled step time ``step_s``; the chrome
    trace goes to ``out_dir``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.fit(n_epochs=2, lr=1e-2, S=S)  # warm the allocator outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.fit(n_epochs=steps, lr=1e-2, S=S)
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies, fills): a CPU op's row
    # repeats the device time of the kernels it launched, and a device-side
    # user annotation (the optimizer step's) spans kernels listed anyway.
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    check(busy_us > 0, "profiler recorded no device time")
    chol_us = sum(r[1] for r in rows if "cholesky_" in r[0] and "_kernel" in r[0])
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "fit_m200_trace.json"))
    emit("profile", steps=steps, step_ms=step_s * 1e3,
         device_busy_ms_per_step=busy_us / steps / 1e3,
         device_idle_share=1.0 - busy_us / steps / 1e6 / step_s,
         device_events_per_step=sum(r[2] for r in rows) / steps,
         cholesky_share_of_busy=chol_us / busy_us,
         top=[{"name": k[:90], "ms_per_step": us / steps / 1e3, "calls_per_step": n / steps}
              for k, us, n in rows[:top]])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", type=Path,
                        help="also profile 10 steps of the m = 200 fit (device time by "
                             "kernel) and write the chrome trace into DIR")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU", file=sys.stderr)
        return 2
    if not (ROOT / "spatial_alignment_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no spatial_alignment_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    device = "cuda"

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    peaks = _PEAKS["pcie" if "pcie" in name.lower() else "sxm"]
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         peak_bytes_per_s=peaks[0], peak_fp32_flops=peaks[1])

    from spatial_alignment_tpu_torch import VariationalGPSA
    from spatial_alignment_tpu_torch.ops import _build

    seconds, logs = _build.build_all(verbose=True)
    emit("build", seconds=seconds, ptxas={k: [ln for ln in v.splitlines() if "ptxas" in ln]
                                          for k, v in logs.items()})

    phase_parity(device)

    dd200, X200, vi200 = two_view_data(45, 10)
    model = VariationalGPSA(dd200, m_X_per_view=200, m_G=200, n_latent_gps={"expression": 10},
                            fixed_view_idx=0, mean_function="identity_fixed", device=device)
    real_inputs = capture_cholesky_inputs(model)
    check([tuple(a.shape) for a in real_inputs] == [(2, 2, 200, 200), (14, 200, 200)],
          f"main-path cholesky shapes {[tuple(a.shape) for a in real_inputs]}")
    results, real = phase_kernels(device, real_inputs, peaks)

    G_pre, _, _ = model.predict({"expression": X200})
    launches, step_s = phase_fit("fit_m200", model, 200, 5, "mixed")

    dd50, _, _ = two_view_data(10, None)
    model50 = VariationalGPSA(dd50, m_X_per_view=50, m_G=50, n_latent_gps={"expression": None},
                              fixed_view_idx=0, device=device)
    phase_fit("fit_m50", model50, 300, 5, "kl_inverse")

    import numpy as np

    G_post, F_mean, F_var = model.predict({"expression": X200})
    fwd = model.forward({"expression": X200}, S=5)
    arrays = [G_post["expression"], F_mean["expression"], F_var["expression"], *[d["expression"] for d in fwd]]
    check(all(np.isfinite(a).all() for a in arrays), "predict/forward: non-finite output")
    check(G_post["expression"].shape == (4050, 2) and F_mean["expression"].shape == (4050, 30),
          "predict: unexpected shapes")
    check(fwd[1]["expression"].shape == (5, 4050, 2), "forward: unexpected sample shape")
    emit("predict", aligned_error_data=aligned_error(X200, vi200),
         aligned_error_init=aligned_error(G_pre["expression"], vi200),
         aligned_error_fit=aligned_error(G_post["expression"], vi200))
    if args.profile is not None:
        phase_profile(model, step_s, args.profile)

    main_shape = results[(14, 200, 200)]
    summary = {"kernels": [{
        "name": "cholesky",
        "route": "cuda",
        "source": "spatial_alignment_tpu_torch/csrc/cholesky.cu",
        "replaces": "spatial_alignment_tpu/ops/pallas_cholesky.py:131",
        "launches": launches,
        "max_abs_err": real[1]["max_abs_err"],
        "ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": [14, 200, 200],
    }]}
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
