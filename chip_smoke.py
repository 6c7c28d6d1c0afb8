#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``spatial_alignment_tpu_torch`` (never the JAX package) through the
entry points a user calls, builds every CUDA kernel from the sources in the
checkout, and holds each kernel against its plain PyTorch version. Three
paths are driven: the default ``fit()`` (Cholesky kernel only); the model
built with the three kernel opt-ins ``cholesky_impl="pallas"``,
``quad_diag_impl="pallas"`` and ``fused_factor_inverse="fused"``
(Cholesky probe, fused factor, triangular solve, quad-diag forward and
backward), each at m = 200 and m = 50 and, past the 240 where the Cholesky
and the fused factor leave shared memory for their panel design, at
m = 384; and the 100k-spot minibatch fit (``fit(minibatch_size=4096)``,
``data_chunk_size``) and its ``predict()``, on the default route and under
``set_gram_force(True)`` (cross-Gram kernel). Every ``fit()`` runs its
step as replays of a captured CUDA graph, so every kernel of every path
launches inside the graph. The launch counts of a captured fit are the
captured step's counts times its replays: each fit_* phase holds them
against the kernels torch.profiler sees over 3 replays more. Phases, one
JSON line each:

  device     nvidia-smi name and power limit, torch / CUDA versions, TF32 flags
  build      nvcc wall time, ptxas registers, shared memory and spills a kernel
  parity     tiny model, and an m = 64 model with the opt-ins: loss and
             gradients on the card vs the CPU path
  model_mb100k  construction of the 100k-spot model (host k-means included:
             the mini-batch branch, above 20,000 points, seconds a call)
  mb100k_first_loss_draws  the 100k model's minibatch loss before training
             on three other draws: default route, forced Gram kernel, and
             float64 on the CPU
  kernels    cholesky at every main-path shape (the m = 200, m = 384 and
             100k (m = 100) fits' slabs, captured from one loss of each), and
             at (2, 256, 256) and (4, 512, 512): error vs the plain version
             on random and on the real inputs (with their cond and jitter
             rung), reconstruction residual, two
             launches bit-equal, L bit-equal to the fused factor's and to
             the column recurrence's (the reference entry
             cholesky_recurrence) at every m, NaN lanes and contract (failing
             pivots in the first, a middle and the last panel), autograd vs
             the plain path, median times, the design (shared memory or
             panel, panel width, blocks per matrix, shared memory); then
             trisolve, quad_fwd, quad_bwd and factor at every
             shape the opt-in fits give them (captured from one loss and
             gradient of each), on random well-conditioned input and on the
             real inputs (trisolve, quad_fwd and quad_bwd launched twice,
             bit-equal; the quad rows carry their design: tiles, splits,
             cluster, and the 3xTF32 bound beside the fp32 one), and the
             solve with L read from global memory (L (640, 640), B
             (640, 32), off the paths);
             then gram at every shape the forced 100k fits and predict() give
             it, for the three kernel kinds, against its plain version and
             the expansion form, with the bfloat16 store, two launches
             bit-equal, its row split, and beside its time an empty
             kernel's, the floor of a launch
  fit_m200   the full-width slice: m = 200, N = 4,050, 10-latent LMC, 200 steps
  fit_m50    the m = 50 two-view grid, no LMC, 300 steps
  fit_m200_pallas  the same model and data as fit_m200 with the opt-ins,
             200 steps: exact launches per step of every kernel, no plain
             call, first loss beside fit_m200's, peak memory
  fit_m50_pallas   the m = 50 grid with the opt-ins, 100 steps (kl_inverse)
  fit_m384   fit_m200's data with m = 384 (the panel designs), 50 steps:
             2 Cholesky launches a step, no plain call, peak memory
  fit_m384_pallas  the same model with the opt-ins, 50 steps: exact
             launches a step of every kernel, first loss beside fit_m384's
  predict    predict() and forward(S=5) on the m = 200 models
  fit_mb100k  the 100k-spot configuration of bench.py (two views of 50,000,
             10 genes, m = 100, LMC 10, data_chunk_size 8192) by minibatch
             SVI, B = 4096 a view, four fit() calls of 250 steps: 2 Cholesky,
             0 Gram launches a step
  fit_mb100k_gram  the same model under set_gram_force(True), 4 x 250
             steps: 2 Gram and 2 Cholesky launches a step; first loss beside
             fit_mb100k's
  fit_mb100k_gram_chunked  the same with data_chunk_size 2048, 100 steps: 5
             Gram launches a step; first loss and peak memory beside the above
  fit_graph_vs_eager  one line a fit route (all nine above): 20 eager
             make_train_step steps and 20 captured fit() steps from the same
             parameters and generator state, losses and parameters bit for
             bit equal; steps/s and peak memory of each, the graph's pool;
             at fit_m200 and fit_mb100k also the non-capturable Adam's
             difference from the captured run, and the same run's from
             parameters one ulp up, the fit's amplification (recorded)
  predict_mb100k  predict() over all 100,000 spots of the forced model: 1 + 16
             Gram launches (16 data-layer chunks), finite (100000, .) outputs,
             aligned error below the data's
  memory_after_fit  the bytes the nine cached graphs keep once fit() has
             returned, and predict_mb100k's peak reserved memory with them
             held and with them dropped; the seconds to capture one again
  resume_on_card  twins of the fit_m200 model: fit(40) against fit(20), save,
             VariationalGPSA.load, fit(20, resume_from=): losses and
             parameters bit for bit equal
  profile    (with --profile DIR) device time per step by kernel over 10
             steps of each fit route, captured and eager, the device's idle
             share, the counters held against the profiler's kernel counts,
             and the captured runs' chrome traces in DIR
  ab_fit_m200  (with --profile DIR) steps/s of the two m = 200 fits in
             turns, default and opt-in, A B B A twice

Every check raises on failure, so any failed phase exits non-zero. The last
two lines are the kernels summary and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or run from a directory without the package, it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

OPT_INS = dict(cholesky_impl="pallas", quad_diag_impl="pallas", fused_factor_inverse="fused")
# Where each kernel's TPU original reaches pl.pallas_call.
REPLACES = {
    "cholesky": "spatial_alignment_tpu/ops/pallas_cholesky.py:131",
    "trisolve": "spatial_alignment_tpu/ops/pallas_trisolve.py:198",
    "quad_fwd": "spatial_alignment_tpu/ops/pallas_quad.py:253",
    "quad_bwd": "spatial_alignment_tpu/ops/pallas_quad.py:284",
    "factor": "spatial_alignment_tpu/ops/pallas_factor.py:197",
    "gram": "spatial_alignment_tpu/ops/pallas_gram.py:117",
}
SOURCES = {
    "cholesky": "cholesky", "trisolve": "trisolve", "quad_fwd": "quad", "quad_bwd": "quad",
    "factor": "factor", "gram": "gram",
}
GRAM_KINDS = ("rbf", "matern12", "matern32")

# Published peaks (dense, no sparsity) used for the bound: memory rate,
# float32 rate outside the tensor cores and TF32 tensor-core rate, by part.
_PEAKS = {
    "sxm": (3.35e12, 67e12, 495e12),
    "pcie": (2.0e12, 51e12, 378e12),
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


_CYCLES_PER_MS = []


def median_ms(fn, n: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the median over ``reps`` batches of
    ``n`` calls of the batch's CUDA-event time over ``n``. Each batch is
    queued behind a device-side sleep longer than the host takes to issue
    it, so the device runs the calls back to back: events around a single
    call would count the host's time to issue it whenever that is the
    longer of the two, as it is for a kernel of a few microseconds."""
    import torch

    if not _CYCLES_PER_MS:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(10**7)
        e.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(10**7 / s.elapsed_time(e))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((2 * issue_ms + 1.0) * _CYCLES_PER_MS[0]))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / n)
    return sorted(times)[reps // 2]


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


def capture_cholesky_inputs(loss):
    """The inputs a path hands the Cholesky in one evaluation of ``loss()``
    (probe slab, then final slab), captured without changing the path."""
    import torch
    from spatial_alignment_tpu_torch.ops import linalg

    captured, orig = [], linalg.cholesky

    def spy(a):
        captured.append(0.5 * (a.detach() + a.detach().transpose(-1, -2)))
        return orig(a)

    linalg.cholesky = spy
    try:
        with torch.no_grad():
            loss()
    finally:
        linalg.cholesky = orig
    return captured


def full_loss(model):
    """One full-batch loss of ``model``, drawn from the model's generator, as
    one training step does."""
    from spatial_alignment_tpu_torch.models import core

    return core.negative_elbo(model.spec, model.params, model.consts, model._batch, 5,
                              generator=model._gen)


def kernel_modules():
    from spatial_alignment_tpu_torch.ops import cholesky, factor, gram, quad, trisolve

    return cholesky, trisolve, quad, factor, gram


def reset_counts():
    from spatial_alignment_tpu_torch import ops

    ops.set_counters(dict.fromkeys(ops.read_counters(), 0))


def read_counts():
    """({kernel: launches}, {module: plain calls}) since the last reset."""
    from spatial_alignment_tpu_torch import ops

    c = ops.read_counters()
    launches = {"cholesky": c["cholesky.launches"], "trisolve": c["trisolve.launches"],
                "quad_fwd": c["quad.fwd_launches"], "quad_bwd": c["quad.bwd_launches"],
                "factor": c["factor.launches"], "gram": c["gram.launches"]}
    plain = {k.split(".")[0]: v for k, v in c.items() if k.endswith(".plain_calls")}
    return launches, plain


def capture_kernel_inputs(model):
    """The inputs the opt-in path hands each new kernel in one loss and
    gradient (forward and backward launches), one entry per distinct call
    signature, captured without changing the path. Uses the model's
    generator, as one training step does."""
    import torch
    from spatial_alignment_tpu_torch.models import core

    _, ts, qd, fc, _ = kernel_modules()
    seen = {}

    def spy(mod, name, key):
        orig = getattr(mod, name)

        def wrapped(*args):
            sig = (key,) + tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args)
            if torch.is_tensor(args[0]) and sig not in seen:
                stride0 = args[0].dim() > 2 and all(v == 0 for v in args[0].stride()[:-2])
                seen[sig] = (key, stride0, [a.detach().clone() if torch.is_tensor(a) else a
                                            for a in args])
            return orig(*args)

        setattr(mod, name, wrapped)
        return mod, name, orig

    spies = [spy(ts, "tri_solve_kernel", "trisolve"), spy(ts, "tri_inverse_kernel", "inverse"),
             spy(qd, "quad_fwd_kernel", "quad_fwd"), spy(qd, "quad_bwd_kernel", "quad_bwd"),
             spy(fc, "cholesky_and_inverse_kernel", "factor")]
    try:
        loss = core.negative_elbo(model.spec, model.params, model.consts, model._batch, 5,
                                  generator=model._gen)
        loss.backward()
    finally:
        for mod, name, orig in spies:
            setattr(mod, name, orig)
    for p in model.parameters():
        p.grad = None
    return list(seen.values())


def minibatch_100k_data():
    """The 100k-spot two-view configuration of bench.py:124-140 (50,000 spots
    a view, 10 genes, an analytic smooth warp), copied so that this script
    imports nothing of the JAX package or its benchmark."""
    import numpy as np

    n = 50_000
    rng = np.random.default_rng(0)
    X1 = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    warp = 0.4 * np.stack(
        [np.sin(X1[:, 0] / 2.0 + 1.0), np.cos(X1[:, 1] / 2.0)], 1
    ).astype(np.float32)
    X = np.concatenate([X1, X1 + warp])
    Y1 = np.stack(
        [np.sin(X1[:, 0] * (j % 3 + 1) / 3.0) + np.cos(X1[:, 1] * (j % 2 + 1) / 2.0)
         for j in range(10)], 1,
    ).astype(np.float32)
    Y = np.concatenate([Y1, Y1])
    return X, Y, [n, n]


def twin(model, **spec_changes):
    """A second model with ``model``'s data, initial parameters and seed (0),
    its spec changed by ``spec_changes``: what the constructor would give
    for the same arguments, without running its host k-means over 100,000
    points again. ``model`` must not have drawn from its generator yet."""
    import copy

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        return tree.detach().clone()

    other = copy.copy(model)
    other.spec = model.spec.replace(**spec_changes)
    other._set_state(clone(model.params), model.consts, model._batch, 0)
    return other


def capture_gram_inputs(*fns):
    """The inputs the calls ``fns`` hand the Gram kernel, one entry per
    distinct (x1 shape, x2 shape, per-group parameters), captured without
    changing the path."""
    import torch

    gm = kernel_modules()[4]
    seen, orig = {}, gm.gram_kernel

    def spy(x1, x2, log_ls, log_var, *args, **kw):
        sig = (tuple(x1.shape), tuple(x2.shape), log_ls.numel() > 1)
        if sig not in seen:
            seen[sig] = [t.detach().clone() for t in (x1, x2, log_ls, log_var)]
        return orig(x1, x2, log_ls, log_var, *args, **kw)

    gm.gram_kernel = spy
    try:
        for fn in fns:
            fn()
    finally:
        gm.gram_kernel = orig
    return list(seen.values())


@contextlib.contextmanager
def forced_gram():
    """Context: every gram without an explicit ``force`` takes the kernel,
    and the switch is back to its default afterwards, whatever happens."""
    gm = kernel_modules()[4]
    gm.set_gram_force(True)
    try:
        yield
    finally:
        gm.set_gram_force(None)


def minibatch_loss(model, B, S=5, seed=123):
    """One minibatch loss of ``model``, its indices and noise drawn from a
    generator of its own seeded with ``seed`` (the model's stays untouched)."""
    import torch
    from spatial_alignment_tpu_torch.models import core

    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return core.negative_elbo_minibatch(
        model.spec, core.minibatch_spec(model.spec, B), model.params, model.consts,
        model._batch, S, generator=gen,
    )


def minibatch_loss_and_grad(model, B, S=5):
    """One minibatch loss and gradient of ``model``, as ``minibatch_loss``."""
    minibatch_loss(model, B, S).backward()
    for p in model.parameters():
        p.grad = None


def first_loss_draws(model, B, seeds=(1, 2, 3), S=5):
    """The minibatch loss of ``model`` at its current parameters from one
    index and noise draw per seed, three ways: float32 on the card by the
    default route and under the forced Gram kernel, and float64 on the CPU
    by the default route (the same draws, cast). How far the two float32
    routes part from each other and from float64 on other draws than the
    fits' first step."""
    import torch
    from spatial_alignment_tpu_torch.models import core

    spec, sub_spec, dev = model.spec, core.minibatch_spec(model.spec, B), model.device

    def cpu64(tree):
        if isinstance(tree, dict):
            return {k: cpu64(v) for k, v in tree.items()}
        return tree.detach().cpu().double() if tree.is_floating_point() else tree.cpu()

    args64 = (cpu64(model.params), cpu64(model.consts), cpu64(model._batch))
    out = []
    for seed in seeds:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        idx = {m.name: torch.stack([torch.randint(n_v, (B,), generator=gen, device=dev)
                                    for n_v in m.n_samples]) for m in spec.modalities}
        wn = torch.randn((S, spec.n_views, B * spec.n_modalities, spec.n_spatial_dims),
                         generator=gen, device=dev)
        dn = {m.name: torch.randn((S, spec.n_views * B, m.n_latent), generator=gen, device=dev)
              for m in spec.modalities}
        draws = dict(indices=idx, warp_noise=wn, data_noise=dn)
        loss = lambda p, c, b, **d: float(core.negative_elbo_minibatch(
            spec, sub_spec, p, c, b, S, **d))
        with torch.no_grad():
            default = loss(model.params, model.consts, model._batch, **draws)
            with forced_gram():
                forced = loss(model.params, model.consts, model._batch, **draws)
            f64 = loss(*args64, **cpu64(draws))
        out.append({"seed": seed, "default": default, "forced": forced, "float64": f64,
                    "rel": abs(forced - default) / abs(default),
                    "default_rel_vs_float64": abs(default - f64) / abs(f64),
                    "forced_rel_vs_float64": abs(forced - f64) / abs(f64)})
    return out


def phase_gram(device, captured, peaks):
    """The Gram kernel at every shape the forced fits and predict() gave it:
    on those real inputs (rbf, the model's kernel), and on random input of
    the same shapes for rbf, matern12 and matern32, against its plain
    version (rel 1e-5: the same float32 operations in the same order, only
    exp / sqrt differ), against the same arithmetic in float64 (rel 1e-6)
    and against the expansion form. That form's |x|^2 + |z|^2 - 2 x.z
    cancels: with |x|^2 <= 200 its squared distance is off by up to about
    6 * 2^-24 * 400 = 1.4e-4, which moves K / var by up to 1.4e-4 / (2 l^2)
    for rbf and 3 * 1.4e-4 / (2 l^2) for matern32 (l >= e^-0.5: 2e-4 and
    6e-4; held at 1e-3), and by sqrt(1.4e-4) / (2 l) = 1e-2 for matern12,
    whose distance is the square root of the cancelled sum (held at 1e-2).
    Then the bfloat16 store once (rel 2^-8, its spacing); two launches
    bit-equal; median times of kernel, plain version and expansion form
    beside the bound and an empty kernel's time, the floor of any launch."""
    import torch

    gm = kernel_modules()[4]
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    rows, bf16 = [], None
    stream = torch.cuda.current_stream().cuda_stream
    empty_ms = median_ms(lambda: gm._library().sat_empty_kernel(stream))
    for x1r, x2r, lsr, varr in captured:
        Kk, Kp = gm.gram_kernel(x1r, x2r, lsr, varr, "rbf"), gm.gram_plain(x1r, x2r, lsr, varr)
        torch.cuda.synchronize()
        real_rel = rel_err(Kk, Kp)
        check(bool(torch.isfinite(Kk).all()), f"gram real {tuple(x2r.shape)}: non-finite")
        check(real_rel <= 1e-5, f"gram real {tuple(x2r.shape)}: rel vs plain {real_rel}")
        real = {"rel_vs_plain": real_rel, "max_abs_err": float((Kk - Kp).abs().max())}
        x1 = 10 * torch.rand(x1r.shape, generator=gen, device=device)
        x2 = 10 * torch.rand(x2r.shape, generator=gen, device=device)
        ls = 1.5 * torch.rand(lsr.shape, generator=gen, device=device) - 0.5
        var = torch.rand(varr.shape, generator=gen, device=device) - 0.5
        n_out = Kk.numel()
        b, by = bound_ms(4 * (x1.numel() + x2.numel() + ls.numel() + var.numel() + n_out),
                         n_out * (3 * x1.shape[-1] + 6), peaks)
        G = math.prod(Kk.shape[:-2])
        for kind in GRAM_KINDS:
            Kk = gm.gram_kernel(x1, x2, ls, var, kind)
            K2 = gm.gram_kernel(x1, x2, ls, var, kind)
            Kp = gm.gram_plain(x1, x2, ls, var, kind)
            Ke = gm.gram(x1, x2, ls, var, kind, force=False)
            K64 = gm.gram_plain(x1.double(), x2.double(), ls.double(), var.double(), kind)
            torch.cuda.synchronize()
            rel_p, rel_e, rel_64 = rel_err(Kk, Kp), rel_err(Kk, Ke), rel_err(Kk, K64)
            tol_e = 1e-2 if kind == "matern12" else 1e-3
            check(rel_p <= 1e-5, f"gram {kind} {tuple(x2.shape)}: rel vs plain {rel_p}")
            check(rel_64 <= 1e-6, f"gram {kind} {tuple(x2.shape)}: rel vs float64 {rel_64}")
            check(rel_e <= tol_e, f"gram {kind} {tuple(x2.shape)}: rel vs expansion {rel_e}")
            check(bit_equal(Kk, K2), f"gram {kind} {tuple(x2.shape)}: two launches differ")
            if bf16 is None:
                Kb = gm.gram_kernel(x1, x2, ls, var, kind, out_dtype=torch.bfloat16)
                Kbp = gm.gram_plain(x1, x2, ls, var, kind, out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                bf16 = {"x2": list(x2.shape), "kind": kind,
                        "rel_vs_plain": rel_err(Kb.float(), Kbp.float())}
                check(Kb.dtype == torch.bfloat16 and bf16["rel_vs_plain"] <= 2.0**-8,
                      f"gram bfloat16 store: {bf16}")
            rows.append({
                "x1": list(x1.shape), "x2": list(x2.shape), "per_group_params": ls.numel() > 1,
                "kind": kind, "rel_vs_plain": rel_p, "rel_vs_float64": rel_64,
                "rel_vs_expansion": rel_e, "expansion_rel_vs_float64": rel_err(Ke, K64),
                "max_abs_err": float((Kk - Kp).abs().max()),
                "real": real if kind == "rbf" else None,
                "kernel_ms": median_ms(lambda: gm.gram_kernel(x1, x2, ls, var, kind)),
                "plain_ms": median_ms(lambda: gm.gram_plain(x1, x2, ls, var, kind)),
                "expansion_ms": median_ms(lambda: gm.gram(x1, x2, ls, var, kind, force=False)),
                "empty_kernel_ms": empty_ms, "bit_equal_twice": True,
                "design": gm.design(G, Kk.shape[-2], Kk.shape[-1]),
                "library_ms": None, "bound_ms": b, "bound_by": by})
    return {"gram": rows, "gram_bf16": bf16}


def parity_data(n_per_view):
    import numpy as np

    rng = np.random.default_rng(0)
    X1 = rng.uniform(0, 10, (n_per_view, 2)).astype(np.float32)
    X = np.concatenate([X1, X1 + 0.1 * rng.standard_normal(X1.shape).astype(np.float32)])
    Y = np.stack([np.sin(X[:, 0] * (j + 1) / 3.0) + np.cos(X[:, 1]) for j in range(3)], 1)
    return {"expression": {"spatial_coords": X, "outputs": Y.astype(np.float32),
                           "n_samples_list": [n_per_view, n_per_view]}}, rng


def parity_case(device, n_per_view, m, lengthscale, **options):
    """Loss and gradients of one model on the CPU and on the card, from the
    same parameters and noise; returns (loss rel, max gradient rel, the
    card run's launches and plain calls)."""
    import numpy as np
    import torch
    from spatial_alignment_tpu_torch import VariationalGPSA
    from spatial_alignment_tpu_torch.models import core

    dd, rng = parity_data(n_per_view)
    kw = dict(m_X_per_view=m, m_G=m, n_latent_gps={"expression": 2}, fixed_view_idx=0,
              **options)
    S = 3
    wn = torch.from_numpy(rng.standard_normal((S, 2, n_per_view, 2)).astype(np.float32))
    dn = torch.from_numpy(rng.standard_normal((S, 2 * n_per_view, 2)).astype(np.float32))
    out = {}
    for dev in ("cpu", device):
        m = VariationalGPSA(dd, device=dev, **kw)
        with torch.no_grad():  # moderate lengthscales keep the Grams well conditioned
            m.params["warp_kernel_lengthscales"].fill_(math.log(lengthscale))
            m.params["data_kernel_lengthscale"].fill_(math.log(lengthscale))
        reset_counts()
        loss = core.negative_elbo(m.spec, m.params, m.consts, m._batch, S,
                                  warp_noise=wn.to(dev), data_noise={"expression": dn.to(dev)})
        loss.backward()
        out[dev] = (float(loss.detach()), [p.grad.detach().cpu() for p in m.parameters()],
                    read_counts())
    (lc, gc, _), (lg, gg, counts) = out["cpu"], out[device]
    loss_rel = abs(lc - lg) / abs(lc)
    grad_rel = max(rel_err(g, c) for g, c in zip(gg, gc) if c.abs().max() > 0)
    return lc, lg, loss_rel, grad_rel, counts


def phase_parity(device):
    """Loss and gradients on the card and on the CPU from the same parameters
    and noise, for a tiny default model and for an m = 64 model with the
    opt-ins (mode mixed, where every new kernel runs); the CPU path is what
    the test suite holds against the JAX package."""
    lc, lg, loss_rel, grad_rel, _ = parity_case(device, 40, 16, 2.0)
    # 1e-4 on the loss and 1e-3 on gradients: f32 with other summation orders
    # and another Cholesky on each side.
    check(loss_rel <= 1e-4, f"card vs CPU loss rel {loss_rel}")
    check(grad_rel <= 1e-3, f"card vs CPU gradient rel {grad_rel}")
    # m = 64 over [0, 10]^2: lengthscale 0.7 keeps its Grams well conditioned.
    olc, olg, oloss_rel, ograd_rel, (launches, plain) = parity_case(
        device, 100, 64, 0.7, **OPT_INS)
    check(oloss_rel <= 1e-4, f"opt-in m=64: card vs CPU loss rel {oloss_rel}")
    check(ograd_rel <= 1e-3, f"opt-in m=64: card vs CPU gradient rel {ograd_rel}")
    check(all(launches[k] > 0 for k in ("trisolve", "quad_fwd", "quad_bwd", "factor")),
          f"opt-in m=64: a kernel did not launch on the card: {launches}")
    check(not any(plain.values()), f"opt-in m=64: plain versions ran on the card: {plain}")
    emit("parity", loss_cpu=lc, loss_gpu=lg, loss_rel=loss_rel, max_grad_rel=grad_rel,
         optin_m64={"loss_cpu": olc, "loss_gpu": olg, "loss_rel": oloss_rel,
                    "max_grad_rel": ograd_rel, "launches": launches})


def phase_kernels(device, real_inputs, peaks):
    """The Cholesky kernel on random well-conditioned input at the fixed
    shapes and at the shape of every real input, then on the real inputs
    (the main paths' Grams with their jitter)."""
    import torch
    from spatial_alignment_tpu_torch.ops import cholesky as ch

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    shapes = [(2, 50, 50), (34, 50, 50), (2, 2, 200, 200), (14, 200, 200), (2, 256, 256),
              (2, 2, 384, 384), (14, 384, 384), (4, 512, 512)]
    shapes += [tuple(A.shape) for A in real_inputs if tuple(A.shape) not in shapes]
    results = {}
    for shape in shapes:
        m = shape[-1]
        B = math.prod(shape[:-2])
        A = spd(gen, B, m, device).reshape(shape)
        Lk = ch.cholesky_kernel(A)
        Lk2 = ch.cholesky_kernel(A)
        Lp = ch.cholesky_plain(A)
        torch.cuda.synchronize()
        rel = rel_err(Lk, Lp)
        res = residual(Lk, A)
        upper_zero = bool((torch.triu(Lk, 1) == 0).all())
        # 1e-4 vs plain, 1e-5 residual: well-conditioned (cond < ~10) f32 input.
        check(rel <= 1e-4, f"cholesky {shape}: rel err vs plain {rel}")
        check(res <= 1e-5, f"cholesky {shape}: residual {res}")
        check(upper_zero, f"cholesky {shape}: nonzero above the diagonal")
        check(bit_equal(Lk, Lk2), f"cholesky {shape}: two launches differ")
        held_l = same_l(A, Lk)
        # The panel design in one block a matrix, beside the cluster the
        # kernel picks: the same L bit for bit, and its time.
        one_block = None
        if ch.blocks_per_matrix(B, m) > 1:
            check(bit_equal(ch.cholesky_kernel(A, blocks=1), Lk),
                  f"cholesky {shape}: one block a matrix differs from the cluster")
            one_block = median_ms(lambda: ch.cholesky_kernel(A, blocks=1))
        # Bound: each input byte read once, each output byte written once,
        # m^3/3 flops per matrix, against the part's published peaks.
        t_bytes = 2 * B * m * m * 4 / peaks[0] * 1e3
        t_ops = B * m**3 / 3 / peaks[1] * 1e3
        results[tuple(shape)] = {
            "shape": list(shape), "smem": ch.uses_shared_memory(m), "design": ch.design(m),
            "smem_bytes": ch._library().sat_cholesky_smem_bytes(m),
            "panel_nb": ch._library().sat_cholesky_panel(),
            "blocks_per_matrix": ch.blocks_per_matrix(B, m),
            "bit_equal_twice": True,
            "l_bit_equal_to_factor_and_recurrence": held_l, "rel_vs_plain": rel,
            "residual": res,
            "max_abs_err": float((Lk - Lp).abs().max()),
            "kernel_ms": median_ms(lambda: ch.cholesky_kernel(A)),
            "kernel_ms_one_block": one_block,
            "plain_ms": median_ms(lambda: ch.cholesky_plain(A)),
            "library_ms": median_ms(lambda: torch.linalg.cholesky(A)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }

    # The real inputs of the m = 200, m = 384 and 100k (m = 100) paths:
    # near-singular kernel Grams with their probe and final jitter. A probe
    # slab stacks the 1x and 10x rungs: its first lane without NaN is the
    # rung the path takes (100x when neither factors).
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
        check(bit_equal(Lk, ch.cholesky_kernel(A)), f"real {tuple(A.shape)}: two launches differ")
        rungs = None
        if A.dim() == 4:
            rungs = [1 if not nan_k[0, b] else 10 if not nan_k[1, b] else 100
                     for b in range(A.shape[1])]
        real.append({"shape": list(A.shape), "cond": cond, "rel_vs_plain": rel, "residual": res,
                     "max_abs_err": float((Lk[ok] - Lp[ok]).abs().max()),
                     "nan_lanes": int(nan_k.sum()), "jitter_rungs": rungs, "bit_equal_twice": True,
                     "l_bit_equal_to_factor_and_recurrence": same_l(A, Lk)})

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
    # Failing pivots in the first, a middle and the last 32-column panel
    # (lanes 1-3; lanes 0 and 4 are SPD), at the paths' widths.
    for m in (384, 200, 50):
        A = spd(gen, 5, m, device)
        for lane, p in zip((1, 2, 3), (3, m // 2, m - 1)):
            A[lane, p, p] = -5.0
        Lk = ch.cholesky_kernel(A)
        torch.cuda.synchronize()
        lower = torch.tril(torch.ones(m, m, dtype=torch.bool, device=device))
        check(bool(torch.isnan(Lk[1:4][:, lower]).all()), f"cholesky m={m}: panel lanes not NaN")
        check(bool((Lk[1:4][:, ~lower] == 0).all()), f"cholesky m={m}: panel lanes not 0 above")
        rel = rel_err(Lk[[0, 4]], ch.cholesky_plain(A[[0, 4]]))
        check(rel <= 1e-4, f"cholesky m={m}: lanes beside the failed ones: rel {rel}")
        same_l(A, Lk)

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
    record = {"random_spd": list(results.values()), "real_grams": real,
              "nan_contract": "ok", "grad_rel_vs_plain": grad_rel}
    return record, results, real


def ptxas_report(log: str) -> dict:
    """{kernel: registers, shared memory, stack and spill bytes} from nvcc's
    ``-Xptxas -v`` output; a kernel is named by its function and the
    integers of its template arguments (quad_bwd_tc_kernel<1,25>: the dF
    kernel with 25 column tiles)."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", ln)
        if entry:
            name = re.search(r"\d([a-z_]+_kernel)(.*)", entry.group(1))
            args = re.findall(r"L[a-z](\d+)E", name.group(2)) if name else []
            cur = (name.group(1) if name else entry.group(1)) + (
                f"<{','.join(args)}>" if args else "")
            out[cur] = {}
        elif cur is not None:
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", ln)
            used = re.search(r"Used (\d+) registers", ln)
            smem = re.search(r"(\d+) bytes smem", ln)
            if frame:
                out[cur].update(stack=int(frame.group(1)), spill_stores=int(frame.group(2)),
                                spill_loads=int(frame.group(3)))
            if used:
                out[cur]["registers"] = int(used.group(1))
            if smem:
                out[cur]["static_smem"] = int(smem.group(1))
    return out


def bit_equal(a, b) -> bool:
    """Equal bit for bit, NaN lanes included."""
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def same_l(A, L):
    """Hold the Cholesky kernel's L (``L``, of ``A``) equal bit for bit to the
    fused factor's, which runs the same blocked routines, and to the column
    recurrence's (the reference entry ``cholesky_recurrence``), whose
    rounding both designs keep, at every m. True when held."""
    from spatial_alignment_tpu_torch.ops import cholesky as ch
    from spatial_alignment_tpu_torch.ops import factor

    check(bit_equal(factor.cholesky_and_inverse_kernel(A)[0], L),
          f"{tuple(A.shape)}: the Cholesky kernel's L differs from the fused factor's")
    check(bit_equal(ch.cholesky_recurrence(A), L),
          f"{tuple(A.shape)}: the Cholesky kernel's L differs from the column recurrence's")
    return True


def bound_ms(n_bytes, n_ops, peaks, op_rate=None):
    """(least time in ms, what sets it) for moving n_bytes and doing n_ops
    operations at the part's published peaks (fp32 unless op_rate)."""
    t_bytes, t_ops = n_bytes / peaks[0] * 1e3, n_ops / (op_rate or peaks[1]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def torch_isfinite_lanes(t):
    import torch

    return torch.isfinite(t).flatten(-2).all(-1)


def cond2(a) -> float:
    """Largest 2-norm condition number over the batch, in float64."""
    import torch

    s = torch.linalg.svdvals(a.double())
    return float((s[..., 0] / s[..., -1]).max())


def well_conditioned_factor(gen, shape, device):
    import torch

    m = shape[-1]
    B = math.prod(shape[:-2])
    return torch.linalg.cholesky(spd(gen, B, m, device)).reshape(shape)


def check_trisolve(L, B, trans, tol_rel, what):
    """Kernel vs plain on (L, B): NaN lanes, rel error on the finite lanes,
    the normwise backward error |op(L) X - B| / (|L| |X|) <= m 2^-24, and
    the residual |op(L) X - B| / |B| (recorded)."""
    import torch
    from spatial_alignment_tpu_torch.ops import trisolve as ts

    Xk = ts.tri_solve_kernel(L, B, trans)
    Xk2 = ts.tri_solve_kernel(L, B, trans)
    Xp = ts.tri_solve_plain(L, B, trans)
    torch.cuda.synchronize()
    check(bit_equal(Xk, Xk2), f"{what}: two launches differ")
    fk, fp = torch_isfinite_lanes(Xk), torch_isfinite_lanes(Xp)
    check(bool((fk == fp).all()), f"{what}: non-finite lanes differ")
    Lf = L.expand(B.shape[:-2] + L.shape[-2:])[fk].double()
    op = Lf.transpose(-1, -2) if trans else Lf
    X64 = Xk[fk].double()
    R = op @ X64 - B[fk].double()
    norm = torch.linalg.matrix_norm
    back = float((norm(R) / (norm(Lf) * norm(X64)).clamp_min(1e-300)).max())
    resid = float((norm(R) / norm(B[fk].double()).clamp_min(1e-300)).max())
    rel = rel_err(Xk[fk], Xp[fk])
    m = L.shape[-1]
    check(back <= m * 2.0**-24, f"{what}: backward error {back}")
    check(rel <= tol_rel, f"{what}: rel vs plain {rel} (bound {tol_rel})")
    return {"rel_vs_plain": rel, "backward_error": back, "residual": resid,
            "max_abs_err": float((Xk[fk] - Xp[fk]).abs().max()),
            "nonfinite_lanes": int((~fk).sum()), "bit_equal_twice": True}


def check_factor(A, real, what):
    """Fused kernel vs plain: NaN lanes, rel error, |L L^T - A| / |A| and
    |L L^-1 - I|, the latter two within f32 backward-stability bounds."""
    import torch
    from spatial_alignment_tpu_torch.ops import factor

    Lk, Ik = factor.cholesky_and_inverse_kernel(A)
    Lp, Ip = factor.cholesky_and_inverse_plain(A)
    L2, I2 = factor.cholesky_and_inverse_kernel(A)
    torch.cuda.synchronize()
    check(torch.equal(Lk.view(torch.int32), L2.view(torch.int32))
          and torch.equal(Ik.view(torch.int32), I2.view(torch.int32)),
          f"{what}: two launches differ")
    nk, np_ = ~torch_isfinite_lanes(Lk), ~torch_isfinite_lanes(Lp)
    check(bool((nk == np_).all()), f"{what}: NaN lanes differ")
    check(bool((torch.isnan(Ik).flatten(-2).any(-1) == nk).all()), f"{what}: L^-1 NaN lanes")
    ok = ~nk
    m = A.shape[-1]
    cond = cond2(A[ok]) if real else 10.0
    rel = max(rel_err(Lk[ok], Lp[ok]), rel_err(Ik[ok], Ip[ok]))
    res_l = residual(Lk[ok], A[ok])
    eye = torch.eye(m, dtype=torch.float64, device=A.device)
    res_i = float((Lk[ok].double() @ Ik[ok].double() - eye).abs().max())
    # The factor is backward stable (residual 1e-5); factor and inverse may
    # differ from the plain chain by ~cond * 2^-24, and L L^-1 - I by
    # ~cond(L) 2^-24 = sqrt(cond) 2^-24, times m for the sum.
    rel_bound = max(1e-4, 10 * cond * 2.0**-24)
    inv_bound = max(1e-5, m * math.sqrt(cond) * 2.0**-24)
    check(res_l <= 1e-5, f"{what}: residual {res_l}")
    check(rel <= rel_bound, f"{what}: rel vs plain {rel} (bound {rel_bound})")
    check(res_i <= inv_bound, f"{what}: |L L^-1 - I| {res_i} (bound {inv_bound})")
    upper = torch.triu(torch.ones(m, m, dtype=torch.bool, device=A.device), 1)
    check(bool((Lk[..., upper] == 0).all() and (Ik[..., upper] == 0).all()),
          f"{what}: nonzero above the diagonal")
    return {"cond": cond if real else None, "rel_vs_plain": rel, "residual": res_l,
            "inverse_residual": res_i, "nan_lanes": int(nk.sum()),
            "max_abs_err": max(float((Lk[ok] - Lp[ok]).abs().max()),
                               float((Ik[ok] - Ip[ok]).abs().max()))}


def phase_new_kernels(device, captured, peaks):
    """trisolve, quad_fwd, quad_bwd and factor against their plain versions
    at every shape the opt-in fits give them (``captured``: the real inputs
    of one loss and gradient of each), on those real inputs and on random
    well-conditioned input of the same shape; NaN lanes; autograd on the card
    vs the plain path on the CPU; median times beside the bound."""
    import torch
    from spatial_alignment_tpu_torch.ops import factor, quad
    from spatial_alignment_tpu_torch.ops import trisolve as ts

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    rows = {"trisolve": [], "quad_fwd": [], "quad_bwd": [], "factor": []}
    for key, stride0, args in captured:
        if key == "trisolve":
            L, B, trans = args
            if stride0:
                L = L[(0,) * (L.dim() - 2)].expand(L.shape)
            m, n = L.shape[-1], B.shape[-1]
            batch = math.prod(B.shape[:-2])
            n_factors = 1 if (stride0 or L.dim() == 2) else batch
            real = check_trisolve(L, B, trans, max(1e-4, 10 * cond2(L.reshape(-1, m, m)[:n_factors])
                                                   * 2.0**-24), f"trisolve real {tuple(B.shape)}")
            Lr = well_conditioned_factor(gen, (n_factors, m, m), device)
            Lr = Lr[0].expand(L.shape) if n_factors == 1 and L.dim() > 2 else Lr.reshape(L.shape)
            Br = torch.randn(B.shape, generator=gen, device=device)
            rand = check_trisolve(Lr, Br, trans, 1e-4, f"trisolve random {tuple(B.shape)}")
            b, by = bound_ms(4 * (n_factors * m * (m + 1) / 2 + 2 * batch * m * n),
                             batch * n * m * m, peaks)
            rows["trisolve"].append({
                "L": list(L.shape), "B": list(B.shape), "trans": trans,
                "factor_shared": n_factors == 1, "smem": ts.uses_shared_memory(m, n),
                "panel_rows": ts._library().sat_trisolve_panel_rows(),
                "real": real, "random": rand,
                "kernel_ms": median_ms(lambda: ts.tri_solve_kernel(L, B, trans)),
                "plain_ms": median_ms(lambda: ts.tri_solve_plain(L, B, trans)),
                "library_ms": median_ms(lambda: torch.linalg.solve_triangular(
                    L.transpose(-1, -2) if trans else L, B, upper=trans)),
                "bound_ms": b, "bound_by": by})
        elif key == "quad_fwd":
            x, F = args
            G, N, m = x.shape
            Lc = F.shape[-3]
            yk, yp = quad.quad_fwd_kernel(x, F), quad.quad_diag_plain(x, F)
            xr = torch.randn(x.shape, generator=gen, device=device)
            Fr = 0.1 * torch.randn(F.shape, generator=gen, device=device)
            rk, rp = quad.quad_fwd_kernel(xr, Fr), quad.quad_diag_plain(xr, Fr)
            twice = [quad.quad_fwd_kernel(x, F), quad.quad_fwd_kernel(xr, Fr)]
            torch.cuda.synchronize()
            # Sums of m squares of m-term dot products: f32 in another order,
            # the products in 3xTF32 (each about 2^-21 of a product off).
            rel_real, rel_rand = rel_err(yk, yp), rel_err(rk, rp)
            check(bool(torch.isfinite(yk).all()), "quad_fwd real: non-finite output")
            check(rel_real <= 1e-4, f"quad_fwd real {tuple(x.shape)}: rel {rel_real}")
            check(rel_rand <= 1e-4, f"quad_fwd random {tuple(x.shape)}: rel {rel_rand}")
            check(torch.equal(yk, twice[0]) and torch.equal(rk, twice[1]),
                  f"quad_fwd {tuple(x.shape)}: two launches differ")
            qlib = quad._library()
            # The kernel's work: three TF32 products per fp32 product, at
            # the TF32 peak; the fp32 bound of the first design beside it.
            n_bytes = 4 * (x.numel() + F.numel() + G * Lc * N)
            b, by = bound_ms(n_bytes, 3 * 2 * G * N * Lc * m * m, peaks, peaks[2])
            b32, _ = bound_ms(n_bytes, 2 * G * N * Lc * m * m, peaks)
            rows["quad_fwd"].append({
                "x": list(x.shape), "F": list(F.shape), "rel_vs_plain": rel_real,
                "rel_vs_plain_random": rel_rand, "max_abs_err": float((yk - yp).abs().max()),
                "bit_equal_twice": True, "products": "3xTF32 mma.sync m16n8k8",
                "tile": [qlib.sat_quad_fwd_tile_rows(G, N, m, Lc),
                         qlib.sat_quad_fwd_tile_cols(G, N, m, Lc)],
                "cluster_k_splits": qlib.sat_quad_fwd_cluster(G, N, m, Lc),
                "kernel_ms": median_ms(lambda: quad.quad_fwd_kernel(x, F)),
                "plain_ms": median_ms(lambda: quad.quad_diag_plain(x, F)),
                "library_ms": median_ms(lambda: x.unsqueeze(1) @ F),
                "library": "torch.matmul producing t only",
                "bound_ms": b, "bound_by": by, "bound_fp32_ms": b32})
        elif key == "quad_bwd":
            x, F, dy = args
            G, N, m = x.shape
            Lc = F.shape[-3]
            dxk, dFk = quad.quad_bwd_kernel(x, F, dy)
            dxp, dFp = quad.quad_bwd_plain(x, F, dy)
            xr = torch.randn(x.shape, generator=gen, device=device)
            Fr = 0.1 * torch.randn(F.shape, generator=gen, device=device)
            dyr = torch.randn(dy.shape, generator=gen, device=device)
            rk, rp = quad.quad_bwd_kernel(xr, Fr, dyr), quad.quad_bwd_plain(xr, Fr, dyr)
            twice = [quad.quad_bwd_kernel(x, F, dy), quad.quad_bwd_kernel(xr, Fr, dyr)]
            torch.cuda.synchronize()
            rel_real = max(rel_err(dxk, dxp), rel_err(dFk, dFp))
            rel_rand = max(rel_err(rk[0], rp[0]), rel_err(rk[1], rp[1]))
            # Sums of signed products over N points and L channels: 1e-4 on
            # random input; the real cotangents cancel more, so 1e-3 there.
            check(bool(torch.isfinite(dxk).all() and torch.isfinite(dFk).all()),
                  "quad_bwd real: non-finite output")
            check(rel_real <= 1e-3, f"quad_bwd real {tuple(x.shape)}: rel {rel_real}")
            check(rel_rand <= 1e-4, f"quad_bwd random {tuple(x.shape)}: rel {rel_rand}")
            check(all(bit_equal(a, b) for a, b in zip(twice[0] + twice[1], (dxk, dFk) + rk)),
                  f"quad_bwd {tuple(x.shape)}: two launches differ")
            # The work: t, dx and dF, three products of 2 G N L m^2, each in
            # 3xTF32 (three TF32 passes) at the TF32 peak, as the forward's
            # bound counts; the fp32 bound of the same three products beside.
            n_bytes = 4 * (2 * x.numel() + 2 * F.numel() + dy.numel())
            b, by = bound_ms(n_bytes, 3 * 3 * 2 * G * N * Lc * m * m, peaks, peaks[2])
            b32, _ = bound_ms(n_bytes, 3 * 2 * G * N * Lc * m * m, peaks)
            design = quad.bwd_design(G, N, m, Lc, G if F.dim() == 4 else 1)
            rows["quad_bwd"].append({
                "x": list(x.shape), "F": list(F.shape), "rel_vs_plain": rel_real,
                "rel_vs_plain_random": rel_rand,
                "max_abs_err": max(float((dxk - dxp).abs().max()), float((dFk - dFp).abs().max())),
                "bit_equal_twice": True,
                # Above m = 512 (no column tiles) the first design runs, in fp32.
                "products": ("3xTF32 mma.sync m16n8k8" if list(design.values())[0]
                             else "fp32 tiles (first design)"),
                "design": design,
                "cluster": 1, "bound_fp32_ms": b32,
                "kernel_ms": median_ms(lambda: quad.quad_bwd_kernel(x, F, dy), n=30),
                "plain_ms": median_ms(lambda: quad.quad_bwd_plain(x, F, dy), n=30),
                "library_ms": None, "bound_ms": b, "bound_by": by})
        elif key == "factor":
            (A,) = args
            Bn, m = math.prod(A.shape[:-2]), A.shape[-1]
            real = check_factor(A, True, f"factor real {tuple(A.shape)}")
            rand = check_factor(spd(gen, Bn, m, device).reshape(A.shape), False,
                                f"factor random {tuple(A.shape)}")
            b, by = bound_ms(4 * 3 * Bn * m * m, Bn * 2 * m**3 / 3, peaks)

            def chain():
                Lc, _ = torch.linalg.cholesky_ex(A)
                eye = torch.eye(m, device=A.device).expand(A.shape)
                return torch.linalg.solve_triangular(Lc, eye, upper=False)

            # The fused factor and the Cholesky kernel run the same blocked
            # routine: the same L bit for bit, the column recurrence's, on
            # the real slab and on random input.
            from spatial_alignment_tpu_torch.ops import cholesky as ch
            held_l = same_l(A, ch.cholesky_kernel(A))
            Ar = spd(gen, Bn, m, device).reshape(A.shape)
            same_l(Ar, ch.cholesky_kernel(Ar))
            rows["factor"].append({
                "shape": list(A.shape), "smem": factor.uses_shared_memory(m),
                "design": factor.design(m), "real": real,
                "random": rand, "panel_nb": factor._library().sat_factor_panel(),
                "blocks_per_matrix": 1,
                "l_bit_equal_to_cholesky_kernel": held_l,
                "kernel_ms": median_ms(lambda: factor.cholesky_and_inverse_kernel(A)),
                "plain_ms": median_ms(lambda: factor.cholesky_and_inverse_plain(A)),
                "library_ms": median_ms(chain),
                "library": "torch.linalg.cholesky_ex then solve_triangular (two calls)",
                "bound_ms": b, "bound_by": by})
        else:
            raise AssertionError(f"unexpected capture {key}")

    # The identity right-hand side (the unfused opt-in's tri_inverse of the
    # Kuu lanes, and the fused factor's above m = 240): random factors, and
    # a NaN pivot that must stay in its lane.
    inverse = []
    for shape in [(2, 200, 200), (2, 50, 50)]:
        L = well_conditioned_factor(gen, shape, device)
        L[0, 7, 7] = float("nan")
        Ik = ts.tri_inverse_kernel(L)
        Ip = ts.tri_inverse_plain(L[1:])
        torch.cuda.synchronize()
        check(not bool(torch.isfinite(Ik[0]).all()), f"tri_inverse {shape}: NaN pivot lost")
        rel = rel_err(Ik[1:], Ip)
        check(rel <= 1e-4, f"tri_inverse {shape}: rel {rel}")
        check(bool((torch.triu(Ik[1:], 1) == 0).all()), f"tri_inverse {shape}: not lower")
        L = L[1:].expand(shape)
        m = shape[-1]
        eye = torch.eye(m, device=device).expand(shape)
        b, by = bound_ms(4 * shape[0] * (m * (m + 1) / 2 + m * m), shape[0] * m**3 / 3, peaks)
        inverse.append({"shape": list(shape), "rel_vs_plain": rel,
                        "kernel_ms": median_ms(lambda: ts.tri_inverse_kernel(L)),
                        "plain_ms": median_ms(lambda: ts.tri_inverse_plain(L)),
                        "library_ms": median_ms(lambda: torch.linalg.solve_triangular(
                            L, eye, upper=False)),
                        "library": "torch.linalg.solve_triangular(L, I, upper=False)",
                        "bound_ms": b, "bound_by": by})

    # The solve with L read from global memory (two staged panels and the
    # tile overrun shared memory past m = 592 against 32 columns): off the
    # paths, a user's m above 592.
    global_l = []
    for trans in (False, True):
        m, n = 640, 32
        L = well_conditioned_factor(gen, (1, m, m), device)
        B = torch.randn(1, m, n, generator=gen, device=device)
        check(not ts.uses_shared_memory(m, n), "trisolve (640, 32): expected L in global memory")
        rec = check_trisolve(L, B, trans, 1e-4, f"trisolve global L trans={trans}")
        b, by = bound_ms(4 * (m * (m + 1) / 2 + 2 * m * n), n * m * m, peaks)
        op = L.transpose(-1, -2) if trans else L
        global_l.append({"L": [1, m, m], "B": [1, m, n], "trans": trans, "smem": False,
                         "random": rec,
                         "kernel_ms": median_ms(lambda: ts.tri_solve_kernel(L, B, trans)),
                         "plain_ms": median_ms(lambda: ts.tri_solve_plain(L, B, trans)),
                         "library_ms": median_ms(lambda: torch.linalg.solve_triangular(
                             op, B, upper=trans)),
                         "bound_ms": b, "bound_by": by})

    # NaN pivot in a solve with several lanes, and a failed lane in the
    # fused factor (the jitter probes' contract).
    L = well_conditioned_factor(gen, (3, 200, 200), device)
    L[1, 5, 5] = float("nan")
    X = ts.tri_solve_kernel(L, torch.randn(3, 200, 10, generator=gen, device=device))
    torch.cuda.synchronize()
    check(torch_isfinite_lanes(X).tolist() == [True, False, True], "trisolve: NaN lane leaked")
    A = spd(gen, 4, 200, device)
    A[1] -= 3.0 * torch.eye(200, device=device)
    Lk, Ik = factor.cholesky_and_inverse_kernel(A)
    torch.cuda.synchronize()
    lower = torch.tril(torch.ones(200, 200, dtype=torch.bool, device=device))
    for out in (Lk, Ik):
        check(bool(torch.isnan(out[1][lower]).all()), "factor: failed lane not NaN below")
        check(bool((out[1][~lower] == 0).all()), "factor: failed lane not 0 above")
        check(bool(torch.isfinite(out[[0, 2, 3]]).all()), "factor: failed lane leaked")
    # Failing pivots in the first, a middle and the last 32-column panel
    # (lanes 1-3; lanes 0 and 4 are SPD), at the paths' widths.
    for m in (384, 200, 50):
        A = spd(gen, 5, m, device)
        for lane, p in zip((1, 2, 3), (3, m // 2, m - 1)):
            A[lane, p, p] = -5.0
        Lk, Ik = factor.cholesky_and_inverse_kernel(A)
        Lp, Ip = factor.cholesky_and_inverse_plain(A[[0, 4]])
        torch.cuda.synchronize()
        lower = torch.tril(torch.ones(m, m, dtype=torch.bool, device=device))
        for out in (Lk, Ik):
            check(bool(torch.isnan(out[1:4][:, lower]).all()), f"factor m={m}: panel lanes not NaN")
            check(bool((out[1:4][:, ~lower] == 0).all()), f"factor m={m}: panel lanes not 0 above")
        rel = max(rel_err(Lk[[0, 4]], Lp), rel_err(Ik[[0, 4]], Ip))
        check(rel <= 1e-4, f"factor m={m}: lanes beside the failed ones: rel {rel}")

    # Autograd through each kernel on the card vs the plain path on the CPU.
    Lg = well_conditioned_factor(gen, (2, 200, 200), device)
    Bg = torch.randn(2, 200, 10, generator=gen, device=device)
    xg = torch.randn(5, 1000, 200, generator=gen, device=device)
    Fg = 0.1 * torch.randn(10, 200, 200, generator=gen, device=device)
    xw = torch.randn(1, 1000, 200, generator=gen, device=device)
    Fw = 0.1 * torch.randn(1, 2, 200, 200, generator=gen, device=device)
    Ag = spd(gen, 14, 200, device)
    cases = {
        "trisolve": (lambda L, B: ts.tri_solve(L, B, False), (Lg, Bg)),
        "trisolve_trans": (lambda L, B: ts.tri_solve(L, B, True), (Lg, Bg)),
        "tri_inverse": (ts.tri_inverse, (Lg,)),
        "quad_shared": (quad.quad_diag, (xg, Fg)),
        "quad_per_view": (quad.quad_diag, (xw, Fw)),
        "factor": (lambda A: torch.cat([t.flatten() for t in factor.cholesky_and_inverse(A)]),
                   (Ag,)),
    }
    grad_rel = {}
    for name, (fn, ins) in cases.items():
        grads = []
        for dev in (device, "cpu"):
            leaves = [t.detach().to(dev).clone().requires_grad_(True) for t in ins]
            out = fn(*leaves)
            w = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(dev)
            (out * w).sum().backward()
            grads.append([t.grad.cpu() for t in leaves])
        grad_rel[name] = max(rel_err(g, c) for g, c in zip(*grads))
        check(grad_rel[name] <= 1e-3, f"{name}: gradient rel {grad_rel[name]}")
    return {**rows, "tri_inverse": inverse, "trisolve_global_l": global_l, "nan_contract": "ok",
            "grad_rel_vs_plain": grad_rel}


# Launches per training step of each path, derived from the code. Default
# knobs: the jitter probe and the final factor slab, both Cholesky. Opt-ins:
# one Cholesky probe (two rungs stacked in one launch at m = 200, one rung
# at m = 50), the final slab through the fused factor, two cholesky_solves
# (warp and data layers: two substitutions each) forward and their four
# pullback substitutions backward, the quad-diag forward and backward in
# each layer. No path calls a plain version on the card.
DEFAULT_PER_STEP = {"cholesky": 2, "trisolve": 0, "quad_fwd": 0, "quad_bwd": 0, "factor": 0,
                    "gram": 0}
OPTIN_PER_STEP = {"cholesky": 1, "trisolve": 8, "quad_fwd": 2, "quad_bwd": 2, "factor": 1,
                  "gram": 0}
# The 100k-spot minibatch fit under set_gram_force(True): the warp layer's
# Gram and the data layer's, one per chunk of the 2 x 4096 sub-batch points
# (data_chunk_size 8192 leaves them whole, 2048 cuts them in four).
MB_GRAM_PER_STEP = {**DEFAULT_PER_STEP, "gram": 2}
MB_GRAM_CHUNKED_PER_STEP = {**DEFAULT_PER_STEP, "gram": 5}
MB100K = dict(m_X_per_view=100, m_G=100, n_latent_gps={"expression": 10}, fixed_view_idx=0,
              mean_function="identity_fixed", data_chunk_size=8192)
MB_B = 4096
# The two unchunked 100k fits: 1000 steps in four fit() calls of 250. Each
# call starts Adam afresh, as the JAX package's fit does. On the card one
# call of 1000 steps left the aligned error at 0.19 (data: 0.17), while
# calls of 250 steps brought it to 0.004 after 500 steps and about 1e-4
# from 750 on. The JAX package stalls the same way under one Adam state:
# experiments/out/extreme_scale_mb4096.json, this configuration trained by
# one train loop for 8,400 steps, ends at an aligned error of 0.23.
MB_STEPS, MB_CALLS = 1000, 4


def phase_fit(name, model, n_epochs, S, expect_mode, per_step, minibatch_size=None,
              calls=1):
    """Fit ``n_epochs`` steps, in ``calls`` fit() calls of equal length, with
    every count set to 0 just before and read just after; the counts must be
    exactly ``per_step`` times the steps."""
    import numpy as np
    import torch

    check(model.spec.svgp_solve_mode == expect_mode,
          f"{name}: solve mode {model.spec.svgp_solve_mode}, expected {expect_mode}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses = np.concatenate([
        model.fit(n_epochs=n_epochs // calls, lr=1e-2, S=S, minibatch_size=minibatch_size)
        for _ in range(calls)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain = read_counts()
    check(bool(np.isfinite(losses).all()), f"{name}: non-finite loss")
    window = min(50, n_epochs // 2)  # the first and last 50 steps, or halves of a short fit
    first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
    check(last < first, f"{name}: loss did not fall ({first} -> {last})")
    for kernel, k in per_step.items():
        check(launches[kernel] == k * n_epochs,
              f"{name}: {launches[kernel]} {kernel} launches for {n_epochs} steps, "
              f"expected {k} per step")
    check(not any(plain.values()), f"{name}: plain versions called on the card: {plain}")
    loop = model._train_loop_cache["loop"]
    check(loop.graph is not None, f"{name}: fit() did not capture its step")
    peak = torch.cuda.max_memory_allocated()
    # The counts above are the captured step's counts times its replays; over
    # a few replays more, the kernels the profiler saw must equal them.
    _, window, seen = profiled(lambda: model.fit(n_epochs=WINDOW_STEPS, lr=1e-2, S=S,
                                                 minibatch_size=minibatch_size))
    check(seen == window and all(window[k] == v * WINDOW_STEPS for k, v in per_step.items()),
          f"{name}: over {WINDOW_STEPS} replays the counters {window} against the "
          f"profiler's kernels {seen}")
    emit(name, steps=n_epochs, seconds=dt, steps_per_s=n_epochs / dt, captured=True,
         graph_pool_bytes=graph_pool_bytes(loop),
         launches=launches, launches_per_step={k: v / n_epochs for k, v in launches.items()},
         plain_calls=plain, solve_mode=model.spec.svgp_solve_mode, loss_first=float(losses[0]),
         loss_first50=first, loss_last50=last, peak_mem_bytes=peak,
         minibatch_size=minibatch_size, data_chunk_size=model.spec.data_chunk_size,
         fit_calls=calls, profiler_window={"steps": WINDOW_STEPS, "launches": seen})
    return {"launches": launches, "losses": losses, "peak_mem_bytes": peak}


# Replays of each fit_* phase's profiler window.
WINDOW_STEPS = 3


def profiled(run, trace=None):
    """``run()`` under torch.profiler with every count set to 0 just before:
    (device-side rows (name, self device us, count), the counters' launches
    after, the launches of the port's kernels as the profiler saw them); the
    chrome trace goes to the path ``trace`` when one is given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches, _ = read_counts()
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    # Device-side events only (kernels, copies, fills): a CPU op's row
    # repeats the device time of the kernels it launched, and a device-side
    # user annotation (the optimizer step's) spans kernels listed anyway.
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    # The port's kernels by their names in csrc/; a quad backward is a dx
    # and a dF pass, or one tensor-core kernel launched twice.
    count = lambda *names: sum(r[2] for r in rows if any(n in r[0] for n in names))
    seen = {"cholesky": count("cholesky_smem_kernel", "cholesky_panel_kernel"),
            "trisolve": count("trisolve_kernel"), "quad_fwd": count("quad_fwd_kernel"),
            "quad_bwd": count("quad_bwd_tc_kernel", "quad_dx_kernel", "quad_df_kernel") / 2,
            "factor": count("factor_smem_kernel", "factor_panel_kernel"),
            "gram": count("gram_kernel")}
    return rows, launches, seen


def graph_pool_bytes(loop):
    """Bytes the allocator holds for ``loop``'s captured graph (its private
    pool's segments), or None where the snapshot names no pools."""
    import torch

    pool = tuple(loop.graph.pool())
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == pool)


def phase_graph_vs_eager(name, model, S=5, minibatch_size=None, steps=20,
                         noncapturable=False):
    """The eager make_train_step loop and the captured fit() for ``steps``
    steps each, from the same parameters and generator state (the captured
    one reuses the graph its fit_* phase made): loss traces bit for bit
    equal, parameters too; steps/s and peak memory of each (max allocated
    over the run; beside it the bytes the graph's private pool holds, and
    the bytes the eager run reserved above what it found after
    ``empty_cache``, the pool's unit).
    ``noncapturable`` adds an eager run under the non-capturable Adam the
    port's fit used before its step was captured (bias corrections on the
    host, in float64): its losses' and parameters' largest relative
    difference from the captured run's (the parameters' also after the
    first step, against the eager run's) is recorded, not held. Beside it,
    the witness of how far the fit amplifies a rounding difference: the
    same non-capturable run from parameters one ulp up, its losses'
    largest relative difference from the unperturbed run's."""
    import numpy as np
    import torch

    leaves = model.parameters()
    start = [p.detach().clone() for p in leaves]
    gen_state = model._gen.get_state()
    loop = model._train_loop_cache["loop"]
    runs = {}
    modes = ("eager", "captured") + (("noncapturable", "ulp") if noncapturable else ())
    for mode in modes:
        with torch.no_grad():
            for p, v in zip(leaves, start):
                p.copy_(torch.nextafter(v, torch.full_like(v, math.inf)) if mode == "ulp" else v)
        model._gen.set_state(gen_state)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # so the run's reserved bytes show its own segments
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if mode == "captured":
            losses = model.fit(n_epochs=steps, lr=1e-2, S=S, minibatch_size=minibatch_size)
        else:
            factory = None if mode == "eager" else (lambda p: torch.optim.Adam(p, lr=1e-2))
            step, _ = model.make_train_step(lr=1e-2, S=S, optimizer=factory,
                                            minibatch_size=minibatch_size)
            first = step()
            params1 = [p.detach().clone() for p in leaves]
            losses = torch.stack([first] + [step() for _ in range(steps - 1)]).cpu().numpy()
            del step
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[mode] = {"losses": np.asarray(losses, np.float64),
                      "params1": params1 if mode != "captured" else None,
                      "params": [p.detach().clone() for p in leaves],
                      "steps_per_s": steps / dt,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "reserved_bytes": torch.cuda.max_memory_reserved() - reserved}
    check(model._train_loop_cache["loop"] is loop, f"{name}: the captured run made a new graph")
    check(np.array_equal(runs["eager"]["losses"], runs["captured"]["losses"]),
          f"{name}: captured losses {runs['captured']['losses'][:3]} differ from eager "
          f"{runs['eager']['losses'][:3]}")
    check(all(torch.equal(a, b)
              for a, b in zip(runs["eager"]["params"], runs["captured"]["params"])),
          f"{name}: captured parameters differ from eager")
    extra = {}
    if noncapturable:
        a, b = runs["noncapturable"], runs["captured"]
        check(bool(np.isfinite(a["losses"]).all()), f"{name}: non-finite non-capturable loss")
        loss_rel = np.abs(a["losses"] - b["losses"]) / np.abs(b["losses"])
        extra = {"noncapturable_loss_max_rel": float(loss_rel.max()),
                 "noncapturable_loss_rel_by_step": loss_rel.tolist(),
                 "noncapturable_param_max_rel_step1": max(
                     rel_err(x, y) for x, y in zip(a["params1"], runs["eager"]["params1"])),
                 "noncapturable_param_max_rel": max(rel_err(x, y) for x, y in
                                                    zip(a["params"], b["params"])),
                 "ulp_loss_max_rel": float(np.max(np.abs(runs["ulp"]["losses"] - a["losses"])
                                                  / np.abs(a["losses"])))}
    emit("fit_graph_vs_eager", fit=name, steps=steps, losses_bit_equal=True,
         params_bit_equal=True, loss_first=float(runs["eager"]["losses"][0]),
         **{f"{mode}_steps_per_s": r["steps_per_s"] for mode, r in runs.items() if mode != "ulp"},
         **{f"{mode}_peak_mem_bytes": r["peak_mem_bytes"] for mode, r in runs.items()
            if mode != "ulp"},
         eager_reserved_bytes=runs["eager"]["reserved_bytes"],
         graph_pool_bytes=graph_pool_bytes(loop), **extra)


def phase_memory_after_fit(models, predict, loop_args):
    """What the train loops cached by fit() keep once it returns, and what
    that costs ``predict`` (predict_mb100k): the bytes reserved and the peak
    reserved and allocated during ``predict()`` with every model's graph
    held, then with every graph dropped (as the eager fit left it: its
    activations back in the caching allocator), each after empty_cache; and
    the seconds to build one loop again (``loop_args``: (model, lr, S,
    minibatch_size)), what dropping the graph after each fit would add to
    every fit() call."""
    import gc

    import torch

    pools = {name: graph_pool_bytes(m._train_loop_cache["loop"]) for name, m in models.items()}
    out = {}
    for state in ("held", "dropped"):
        if state == "dropped":
            for m in models.values():
                m.__dict__.pop("_train_loop_cache", None)
            gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        predict()
        torch.cuda.synchronize()
        out[state] = {"reserved_bytes": reserved,
                      "predict_peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                      "predict_peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    model, *args = loop_args
    t0 = time.perf_counter()
    loop = model.make_train_loop(*args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(loop.graph is not None, "memory_after_fit: the rebuilt loop did not capture")
    del loop
    emit("memory_after_fit", graph_pool_bytes=pools, graph_pools_total_bytes=sum(pools.values()),
         device_total_bytes=torch.cuda.get_device_properties(0).total_memory,
         loop_build_seconds=build_s, **out)


def phase_resume(model, n: int = 20, S: int = 5):
    """fit(2n) against fit(n), save, a fresh VariationalGPSA.load and
    fit(n, resume_from=): losses and parameters bit for bit equal, the
    Adam moments and step, the generator's offset and the epoch restored.
    Both start from twins of ``model`` (its data and current parameters)."""
    import numpy as np
    import torch
    from spatial_alignment_tpu_torch import VariationalGPSA

    ref, first = twin(model), twin(model)
    full = ref.fit(n_epochs=2 * n, lr=1e-2, S=S)
    head = first.fit(n_epochs=n, lr=1e-2, S=S)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "resume_m200.npz")
        first.save(path)
        resumed = VariationalGPSA.load(path)
        tail = resumed.fit(n_epochs=n, lr=1e-2, S=S, resume_from=path)
    check(resumed._train_loop_cache["loop"].graph is not None, "resume: not captured")
    check(np.array_equal(np.concatenate([head, tail]), full),
          "resume: the resumed losses differ from the uninterrupted fit's")
    same = [torch.equal(a, b) for a, b in zip(resumed.parameters(), ref.parameters())]
    check(all(same) and len(same) == len(ref.parameters()),
          "resume: the resumed parameters differ from the uninterrupted fit's")
    check(resumed._epoch == 2 * n, f"resume: epoch {resumed._epoch}, expected {2 * n}")
    emit("resume_on_card", fit="fit_m200", steps=2 * n, losses_bit_equal=True,
         params_bit_equal=True, epoch=resumed._epoch, loss_last=float(full[-1]))


def phase_profile(name, model, out_dir: Path, mode: str = "captured", steps: int = 10,
                  S: int = 5, top: int = 15, minibatch_size=None):
    """Device time of ``steps`` training steps by kernel name, from
    torch.profiler, beside the step time of ``2 * steps`` unprofiled steps
    just before it on the same model (the host's pace drifts over a run, so
    the two come from one state); the chrome trace of the captured steps
    goes to ``out_dir``. ``mode`` "captured" runs fit() (graph replays),
    "eager" the make_train_step loop."""
    import torch

    if mode == "captured":
        fit = lambda n: model.fit(n_epochs=n, lr=1e-2, S=S, minibatch_size=minibatch_size)
    else:
        step, _ = model.make_train_step(lr=1e-2, S=S, minibatch_size=minibatch_size)
        fit = lambda n: [step() for _ in range(n)]
    fit(2)  # warm the allocator outside the window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(2 * steps)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (2 * steps)
    trace = None
    if mode == "captured":
        out_dir.mkdir(parents=True, exist_ok=True)
        trace = out_dir / f"{name}_trace.json"
    rows, launches, by_name = profiled(lambda: fit(steps), trace)
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    check(busy_us > 0, "profiler recorded no device time")
    # The port's kernels by their names in csrc/ (cholesky_*_kernel,
    # trisolve_kernel, quad_*_kernel, factor_*_kernel, gram_kernel).
    ours = {k: sum(r[1] for r in rows if k in r[0] and "_kernel" in r[0]) / busy_us
            for k in ("cholesky_", "trisolve_", "quad_", "factor_", "gram_")}
    # The counters against the kernels the profiler saw: under replay the
    # loop adds the captured step's counts, so the two must agree.
    check(by_name == launches,
          f"{name} {mode}: counters {launches} against the profiler's kernels {by_name}")
    emit("profile", fit=name, mode=mode, steps=steps, step_ms=step_s * 1e3,
         launches_per_step={k: v / steps for k, v in launches.items()},
         device_busy_ms_per_step=busy_us / steps / 1e3,
         device_idle_share=1.0 - busy_us / steps / 1e6 / step_s,
         device_events_per_step=sum(r[2] for r in rows) / steps,
         share_of_busy={k.rstrip("_"): v for k, v in ours.items()},
         top=[{"name": k[:90], "ms_per_step": us / steps / 1e3, "calls_per_step": n / steps}
              for k, us, n in rows[:top]])


def phase_ab(models, steps: int = 100, rounds: int = 2, S: int = 5):
    """Steps/s of the m = 200 fit by the default route (A) and by the opt-in
    route (B), in turns A B B A per round, in one process on one card: the
    host's pace drifts from call to call, so only turns within a call
    compare."""
    import torch

    order = [name for _ in range(rounds) for name in ("A", "B", "B", "A")]
    rates = {"A": [], "B": []}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[name].fit(n_epochs=steps, lr=1e-2, S=S)
        torch.cuda.synchronize()
        rates[name].append(steps / (time.perf_counter() - t0))
    emit("ab_fit_m200", order=order, steps_per_fit=steps,
         default_steps_per_s=rates["A"], optin_steps_per_s=rates["B"])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", type=Path,
                        help="also profile 10 steps of every fit route, captured and eager "
                             "(device time by kernel), write the captured runs' chrome "
                             "traces into DIR, and time the two m = 200 fits in turns "
                             "(A B B A)")
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
         peak_bytes_per_s=peaks[0], peak_fp32_flops=peaks[1], peak_tf32_flops=peaks[2])

    from spatial_alignment_tpu_torch import VariationalGPSA
    from spatial_alignment_tpu_torch.ops import _build

    seconds, logs = _build.build_all(verbose=True)
    emit("build", seconds=seconds, ptxas={k: ptxas_report(v) for k, v in logs.items()})

    phase_parity(device)

    # The 100k-spot model, built once through the constructor; its forced
    # and chunked twins start from the same parameters and generator state.
    import numpy as np
    from spatial_alignment_tpu_torch.models import params as params_mod

    Xm, Ym, nslm = minibatch_100k_data()
    ddm = {"expression": {"spatial_coords": Xm, "outputs": Ym, "n_samples_list": nslm}}
    vim = [np.arange(nslm[0]), np.arange(nslm[0], sum(nslm))]
    kmeans_s, kmeans = [], params_mod.kmeans_centers

    def timed_kmeans(x, *a, **kw):
        t = time.perf_counter()
        out = kmeans(x, *a, **kw)
        kmeans_s.append({"points": len(x), "seconds": time.perf_counter() - t,
                         "branch": "minibatch" if len(x) > 20_000 else "exact"})
        return out

    params_mod.kmeans_centers = timed_kmeans
    try:
        t0 = time.perf_counter()
        model_mb = VariationalGPSA(ddm, **MB100K, device=device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        params_mod.kmeans_centers = kmeans
    model_mb_g = twin(model_mb)
    model_mb_gc = twin(model_mb, data_chunk_size=2048)
    check([k["branch"] for k in kmeans_s] == ["minibatch"] * 3,
          f"the 100k model's k-means took {kmeans_s}, expected three mini-batch runs")
    emit("model_mb100k", seconds=build_s, kmeans=kmeans_s,
         kmeans_seconds=sum(k["seconds"] for k in kmeans_s), n_spots=sum(nslm),
         solve_mode=model_mb.spec.svgp_solve_mode, spec_data_chunk_size=[
             m.spec.data_chunk_size for m in (model_mb, model_mb_g, model_mb_gc)])

    dd200, X200, vi200 = two_view_data(45, 10)
    kw200 = dict(m_X_per_view=200, m_G=200, n_latent_gps={"expression": 10}, fixed_view_idx=0,
                 mean_function="identity_fixed", device=device)
    model = VariationalGPSA(dd200, **kw200)
    # The Cholesky's inputs on both main paths: one loss of the m = 200 model
    # from its generator (as its first step, and as its opt-in twin's capture
    # below), and one minibatch loss of the 100k model from a generator of
    # its own (its twins keep the same generator state).
    # The m = 384 model: fit_m200's data with more inducing points, where the
    # Cholesky and the fused factor leave shared memory for their panel
    # designs (m > 240).
    kw384 = {**kw200, "m_X_per_view": 384, "m_G": 384}
    model384 = VariationalGPSA(dd200, **kw384)
    real_inputs = capture_cholesky_inputs(lambda: full_loss(model))
    real_inputs += capture_cholesky_inputs(lambda: minibatch_loss(model_mb, MB_B))
    real_inputs += capture_cholesky_inputs(lambda: full_loss(model384))
    want = [(2, 2, 200, 200), (14, 200, 200), (2, 2, 100, 100), (14, 100, 100),
            (2, 2, 384, 384), (14, 384, 384)]
    check([tuple(a.shape) for a in real_inputs] == want,
          f"main-path cholesky shapes {[tuple(a.shape) for a in real_inputs]}, expected {want}")
    chol_record, results, real = phase_kernels(device, real_inputs, peaks)
    draws = first_loss_draws(model_mb, MB_B)
    emit("mb100k_first_loss_draws", draws=draws, max_rel=max(d["rel"] for d in draws))

    # The opt-in models: the same data and seed as the default ones. Their
    # kernels' inputs come from one loss and gradient of each, drawn from
    # the model's generator as the default model's capture does, so the
    # first training step of each pair sees the same noise.
    model_p = VariationalGPSA(dd200, **kw200, **OPT_INS)
    dd50, _, _ = two_view_data(10, None)
    kw50 = dict(m_X_per_view=50, m_G=50, n_latent_gps={"expression": None}, fixed_view_idx=0,
                device=device)
    model50_p = VariationalGPSA(dd50, **kw50, **OPT_INS)
    model384_p = VariationalGPSA(dd200, **kw384, **OPT_INS)
    captured384 = capture_kernel_inputs(model384_p)
    shapes384 = sorted((key, tuple(args[0].shape)) for key, _, args in captured384)
    want = sorted([("factor", (14, 384, 384)), ("quad_fwd", (5, 4050, 384)),
                   ("quad_fwd", (1, 2025, 384)), ("quad_bwd", (5, 4050, 384)),
                   ("quad_bwd", (1, 2025, 384)), ("trisolve", (384, 384)),
                   ("trisolve", (384, 384)), ("trisolve", (1, 384, 384)),
                   ("trisolve", (1, 384, 384))])
    check(shapes384 == want, f"m = 384 opt-in kernel inputs {shapes384}, expected {want}")
    captured = (capture_kernel_inputs(model_p) + capture_kernel_inputs(model50_p)
                + captured384)
    new_record = phase_new_kernels(device, captured, peaks)
    # The Gram kernel's inputs: one minibatch loss and gradient of each
    # forced 100k model (indices and noise from a generator of their own)
    # and predict() over all 100,000 spots before training.
    pre_mb = []
    with forced_gram():
        gram_captured = capture_gram_inputs(
            lambda: minibatch_loss_and_grad(model_mb_g, MB_B),
            lambda: minibatch_loss_and_grad(model_mb_gc, MB_B),
            lambda: pre_mb.append(model_mb_g.predict({"expression": Xm})[0]["expression"]),
        )
    shapes = sorted((tuple(c[0].shape), tuple(c[1].shape)) for c in gram_captured)
    want = sorted([((1, 100, 2), (1, MB_B, 2)), ((100, 2), (5, 2 * MB_B, 2)),
                   ((100, 2), (5, 2048, 2)), ((1, 100, 2), (1, nslm[0], 2)),
                   ((100, 2), (1, sum(nslm) // 16, 2))])
    check(shapes == want, f"gram shapes on the 100k path {shapes}, expected {want}")
    gram_record = phase_gram(device, gram_captured, peaks)
    emit("kernels", cholesky=chol_record, **new_record, **gram_record)

    G_pre, _, _ = model.predict({"expression": X200})
    fit200 = phase_fit("fit_m200", model, 200, 5, "mixed", DEFAULT_PER_STEP)
    model50 = VariationalGPSA(dd50, **kw50)
    phase_fit("fit_m50", model50, 300, 5, "kl_inverse", DEFAULT_PER_STEP)
    fit200_p = phase_fit("fit_m200_pallas", model_p, 200, 5, "mixed", OPTIN_PER_STEP)
    # The same function from the same parameters and noise: the first
    # losses agree to float32 summation order.
    first_rel = abs(fit200_p["losses"][0] - fit200["losses"][0]) / abs(fit200["losses"][0])
    check(first_rel <= 1e-3, f"fit_m200_pallas: first loss rel {first_rel} vs fit_m200")
    emit("fit_m200_pallas_vs_fit_m200", first_loss_rel=first_rel)
    phase_fit("fit_m50_pallas", model50_p, 100, 5, "kl_inverse", OPTIN_PER_STEP)
    # m = 384: the panel designs of the Cholesky (both routes) and the fused
    # factor (opt-in route); the pair starts from the same parameters and
    # noise, as the m = 200 pair does.
    from spatial_alignment_tpu_torch.ops import cholesky as ch
    from spatial_alignment_tpu_torch.ops import factor as fc

    check(ch.design(384) != "smem" and fc.design(384) != "smem",
          "m = 384: expected the panel designs")
    fit384 = phase_fit("fit_m384", model384, 50, 5, "mixed", DEFAULT_PER_STEP)
    fit384_p = phase_fit("fit_m384_pallas", model384_p, 50, 5, "mixed", OPTIN_PER_STEP)
    rel384 = abs(fit384_p["losses"][0] - fit384["losses"][0]) / abs(fit384["losses"][0])
    check(rel384 <= 1e-3, f"fit_m384_pallas: first loss rel {rel384} vs fit_m384")
    emit("fit_m384_pallas_vs_fit_m384", first_loss_rel=rel384,
         design={"cholesky": ch.design(384), "factor": fc.design(384),
                 "cholesky_blocks_per_matrix": {"probe": ch.blocks_per_matrix(4, 384),
                                                "final": ch.blocks_per_matrix(14, 384)}})

    # Captured against eager: every fit route of the m = 200, m = 50 and
    # m = 384 models, from the parameters its fit_* phase left.
    phase_graph_vs_eager("fit_m200", model, noncapturable=True)
    phase_graph_vs_eager("fit_m50", model50)
    phase_graph_vs_eager("fit_m200_pallas", model_p)
    phase_graph_vs_eager("fit_m50_pallas", model50_p)
    phase_graph_vs_eager("fit_m384", model384)
    phase_graph_vs_eager("fit_m384_pallas", model384_p)

    G_post, F_mean, F_var = model.predict({"expression": X200})
    fwd = model.forward({"expression": X200}, S=5)
    G_post_p, F_mean_p, F_var_p = model_p.predict({"expression": X200})
    arrays = [G_post["expression"], F_mean["expression"], F_var["expression"],
              *[d["expression"] for d in fwd], G_post_p["expression"], F_mean_p["expression"],
              F_var_p["expression"]]
    check(all(np.isfinite(a).all() for a in arrays), "predict/forward: non-finite output")
    for G_, F_ in ((G_post, F_mean), (G_post_p, F_mean_p)):
        check(G_["expression"].shape == (4050, 2) and F_["expression"].shape == (4050, 30),
              "predict: unexpected shapes")
    check(fwd[1]["expression"].shape == (5, 4050, 2), "forward: unexpected sample shape")
    emit("predict", aligned_error_data=aligned_error(X200, vi200),
         aligned_error_init=aligned_error(G_pre["expression"], vi200),
         aligned_error_fit=aligned_error(G_post["expression"], vi200),
         aligned_error_fit_pallas=aligned_error(G_post_p["expression"], vi200))

    # The 100k-spot minibatch fits, default route and forced Gram kernel.
    fit_mb = phase_fit("fit_mb100k", model_mb, MB_STEPS, 5, "mixed", DEFAULT_PER_STEP, MB_B,
                       MB_CALLS)
    with forced_gram():
        fit_mb_g = phase_fit("fit_mb100k_gram", model_mb_g, MB_STEPS, 5, "mixed",
                             MB_GRAM_PER_STEP, MB_B, MB_CALLS)
        fit_mb_gc = phase_fit("fit_mb100k_gram_chunked", model_mb_gc, 100, 5, "mixed",
                              MB_GRAM_CHUNKED_PER_STEP, MB_B)
    # The same indices and noise on each pair: the forced Gram against the
    # expansion form through a near-singular m = 100 factor (1e-3); chunked
    # against whole, the same numbers in another summation order (1e-5).
    loss0_rel = lambda a, b: abs(a["losses"][0] - b["losses"][0]) / abs(b["losses"][0])
    rel_g, rel_gc = loss0_rel(fit_mb_g, fit_mb), loss0_rel(fit_mb_gc, fit_mb_g)
    check(rel_g <= 1e-3, f"fit_mb100k_gram: first loss rel {rel_g} vs fit_mb100k")
    check(rel_gc <= 1e-5, f"fit_mb100k_gram_chunked: first loss rel {rel_gc} vs fit_mb100k_gram")
    emit("fit_mb100k_compare", first_loss_rel_gram_vs_default=rel_g,
         first_loss_rel_chunked_vs_whole=rel_gc,
         peak_mem_bytes={"whole_8192": fit_mb_g["peak_mem_bytes"],
                         "chunked_2048": fit_mb_gc["peak_mem_bytes"],
                         "default_route": fit_mb["peak_mem_bytes"]})

    phase_graph_vs_eager("fit_mb100k", model_mb, minibatch_size=MB_B, noncapturable=True)
    with forced_gram():
        phase_graph_vs_eager("fit_mb100k_gram", model_mb_g, minibatch_size=MB_B)
        phase_graph_vs_eager("fit_mb100k_gram_chunked", model_mb_gc, minibatch_size=MB_B)

    with forced_gram():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        G_mb, F_mb, V_mb = (d["expression"] for d in model_mb_g.predict({"expression": Xm}))
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t0
        launches, plain = read_counts()
    G_def = model_mb.predict({"expression": Xm})[0]["expression"]
    n_mb = sum(nslm)
    check(G_mb.shape == (n_mb, 2) and F_mb.shape == (n_mb, 10) and V_mb.shape == (n_mb, 10),
          f"predict_mb100k: shapes {G_mb.shape}, {F_mb.shape}, {V_mb.shape}")
    check(all(np.isfinite(a).all() for a in (G_mb, F_mb, V_mb, G_def)),
          "predict_mb100k: non-finite output")
    check(launches["gram"] == 1 + 16 and not any(plain.values()),
          f"predict_mb100k: {launches['gram']} Gram launches (expected 1 + 16), plain {plain}")
    err_data, err_fit = aligned_error(Xm, vim), aligned_error(G_mb, vim)
    check(err_fit < err_data, f"predict_mb100k: aligned error {err_data} -> {err_fit}")
    emit("predict_mb100k", seconds=pred_s, launches=launches, aligned_error_data=err_data,
         aligned_error_init=aligned_error(pre_mb[0], vim), aligned_error_fit=err_fit,
         aligned_error_fit_default_route=aligned_error(G_def, vim),
         mse_F_mean=float(np.mean((F_mb - Ym) ** 2)))

    def predict_mb100k():
        with forced_gram():
            return model_mb_g.predict({"expression": Xm})

    phase_memory_after_fit(
        {"fit_m200": model, "fit_m50": model50, "fit_m200_pallas": model_p,
         "fit_m50_pallas": model50_p, "fit_m384": model384, "fit_m384_pallas": model384_p,
         "fit_mb100k": model_mb, "fit_mb100k_gram": model_mb_g,
         "fit_mb100k_gram_chunked": model_mb_gc},
        predict_mb100k, (model_mb, 1e-2, 5, None, MB_B))
    phase_resume(model)

    if args.profile is not None:
        for mode in ("captured", "eager"):
            phase_profile("fit_m200", model, args.profile, mode)
            phase_profile("fit_m50", model50, args.profile, mode)
            phase_profile("fit_m200_pallas", model_p, args.profile, mode)
            phase_profile("fit_m50_pallas", model50_p, args.profile, mode)
            phase_profile("fit_m384", model384, args.profile, mode)
            phase_profile("fit_m384_pallas", model384_p, args.profile, mode)
            phase_profile("fit_mb100k", model_mb, args.profile, mode, minibatch_size=MB_B)
            with forced_gram():
                phase_profile("fit_mb100k_gram", model_mb_g, args.profile, mode,
                              minibatch_size=MB_B)
                phase_profile("fit_mb100k_gram_chunked", model_mb_gc, args.profile, mode,
                              minibatch_size=MB_B)
        phase_ab({"A": model, "B": model_p})

    def entry(kernel, launches, row, max_abs_err, shape):
        return {"name": kernel, "route": "cuda",
                "source": f"spatial_alignment_tpu_torch/csrc/{SOURCES[kernel]}.cu",
                "replaces": REPLACES[kernel], "launches": launches, "max_abs_err": max_abs_err,
                "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": shape}

    # Each kernel at the largest shape of its m = 200 path: the data layer's
    # solve (L (200, 200), B (200, 10)) and quad-diag (x (5, 4050, 200),
    # shared F (10, 200, 200)), the (14, 200, 200) factor slab; the Gram at
    # the 100k fit's data layer (x1 (100, 2), x2 (5, 8192, 2)). Launches are
    # the counts of the path's 200-step fit: fit_m200 for the Cholesky,
    # fit_m200_pallas for the next four, fit_mb100k_gram for the Gram.
    solve = next(r for r in new_record["trisolve"] if r["B"] == [200, 10] and not r["trans"])
    qf = max((r for r in new_record["quad_fwd"] if r["x"][-1] == 200),
             key=lambda r: math.prod(r["x"]))
    qb = max((r for r in new_record["quad_bwd"] if r["x"][-1] == 200),
             key=lambda r: math.prod(r["x"]))
    fac = next(r for r in new_record["factor"] if r["shape"] == [14, 200, 200])
    gr = next(r for r in gram_record["gram"] if r["x2"] == [5, 2 * MB_B, 2] and r["kind"] == "rbf")
    launches_p = fit200_p["launches"]
    main_shape = results[(14, 200, 200)]
    summary = {"kernels": [
        entry("cholesky", fit200["launches"]["cholesky"], main_shape, real[1]["max_abs_err"],
              [14, 200, 200]),
        entry("trisolve", launches_p["trisolve"], solve, solve["real"]["max_abs_err"],
              {"L": [200, 200], "B": [200, 10]}),
        entry("quad_fwd", launches_p["quad_fwd"], qf, qf["max_abs_err"],
              {"x": qf["x"], "F": qf["F"]}),
        entry("quad_bwd", launches_p["quad_bwd"], qb, qb["max_abs_err"],
              {"x": qb["x"], "F": qb["F"]}),
        entry("factor", launches_p["factor"], fac, fac["real"]["max_abs_err"], [14, 200, 200]),
        entry("gram", fit_mb_g["launches"]["gram"], gr, gr["real"]["max_abs_err"],
              {"x1": gr["x1"], "x2": gr["x2"], "kind": gr["kind"]}),
    ]}
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
