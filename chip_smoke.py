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
``set_gram_force(True)`` (cross-Gram kernel); and ``fit_multistart``,
its restarts trained as one captured step whose restart axis is folded
into every kernel's batch, on the m = 50, both m = 200 and the forced 100k
models; and the triangular and whitened variational parameterizations
(bench.py's fourth key at m = 50, the m = 200 model in both, the whitened
one also with the opt-ins, which sends its width-N solves to the solve
kernel, and the forced 100k model whitened) with ``forward(G_test=)``
imputation; and ``WarpGPMLE``, the maximum-likelihood model; and the
command line, ``python -m spatial_alignment_tpu_torch align`` and
``predict`` in subprocesses on the m = 200 model's data; and the
distributed path (``spatial_alignment_tpu_torch.parallel``): a world of
one on NCCL in this process, and two ranks on gloo in subprocesses. From 2,000
points the models resolve the precision names to high/default, which runs
their variance products in one TF32 pass (cuBLAS, and the quad kernels'
one-pass build on the opt-in route). Every ``fit()`` runs its
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
  kernels_precision  the quad kernels' one-pass TF32 build (the name
             "default", which the m = 200 and m = 384 models resolve to) on
             the inputs the opt-in fits hand it: within error_bounds of
             float64 and of the plain version at "default" (cuBLAS TF32),
             two launches bit-equal, timed beside the 3xTF32 build, cuBLAS
             TF32 making t and the one-pass bound
  kernels_variational  the Cholesky at the Kuu-only slabs of the
             triangular and whitened routes ((2, 200, 200), (2, 100, 100)),
             the solve at the whitened opt-in model's width-N shapes (L
             (200, 200) shared, B (5, 200, 4050); L (1, 200, 200), B (1,
             200, 2025); both orientations) and the fused factor at the
             triangular opt-in model's (2, 200, 200), captured from one loss
             and gradient of each, against the plain version, timed beside
             the bound and the library call
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
  fit_m200_highest, fit_m200_pallas_highest  the m = 200 models with both
             precision names at highest (fp32 in cuBLAS, 3xTF32 in the quad
             kernels), 200 steps each
  precision  the names on the card: first loss and gradients with the names
             at high/default against highest, same parameters and draws, on
             both m = 200 routes, at the constructor's parameters and with
             every lengthscale 0.3 and 1.0, beside float64 on the CPU (loss
             within 1e-3; gradients within 1e-2 on each leaf whose float32
             gradient lies within 1e-3 of float64); each route's steps/s and
             aligned error beside its twin's; the TF32 GEMMs of a captured
             step by the profiler (none in the twin's); PyTorch's TF32 flags
             as before the fits
  predict    predict() and forward(S=5) on the m = 200 models
  fit_m50_triangular  bench.py's fourth key (triangular_variational, m = 50,
             kl_inverse) on fit_m50's grid, 300 steps: 2 Cholesky a step (its
             aligned error, like fit_m50's, is still above the data's at
             300 steps; it is held after 700 steps more)
  fit_m200_triangular, fit_m200_whitened  fit_m200's data and model in
             each parameterization (the constructor's init for the same
             seed), 200 steps: 2 Cholesky launches a step
  fit_m200_whitened_pallas  the whitened model with the opt-ins, 200 steps:
             2 Cholesky, 4 solves (one width-N solve a layer and its
             transposed solve), 2 quad forward and 2 backward a step; first
             loss beside fit_m200_whitened's (1e-3)
  variational_equivalence  triangular's first loss against the square
             model's from one set of injected draws (m = 200 and m = 50,
             1e-4); fit_m200's trained square parameters converted to
             whitened ones on the host, w = L^-1 (delta - mu_z),
             A = L^-1 chol(Omega): the two losses at the same draws in
             float64 on the CPU (1e-9) and in float32 on the card (1e-4)
  impute     forward(G_test=) on a 64 x 64 grid over fit_m200_whitened's
             aligned coordinates (S = 5) and on a 250 x 200 grid over the
             whitened 100k model's; imputation at a view's own aligned
             means with the noise zeroed against predict()'s F_mean (1e-5)
  fit_mb100k  the 100k-spot configuration of bench.py (two views of 50,000,
             10 genes, m = 100, LMC 10, data_chunk_size 8192) by minibatch
             SVI, B = 4096 a view, four fit() calls of 250 steps: 2 Cholesky,
             0 Gram launches a step
  fit_mb100k_gram  the same model under set_gram_force(True), 4 x 250
             steps: 2 Gram and 2 Cholesky launches a step; first loss beside
             fit_mb100k's
  fit_mb100k_gram_chunked  the same with data_chunk_size 2048, 100 steps: 5
             Gram launches a step; first loss and peak memory beside the above
  fit_mb100k_gram_whitened  the forced 100k model whitened, trained as its
             square twin (4 x 250 steps: after one call of 250 the aligned
             error was still above the data's, 0.371 in one run and 0.156
             in another): 2 Gram, 2 Cholesky a step
  variational_routes  each triangular and whitened route beside its square
             twin of the same run: steps/s, peak memory, the graph's pool;
             the aligned error, held below the data's
  fit_graph_vs_eager  one line a fit route (all fourteen above): 20 eager
             make_train_step steps and 20 captured fit() steps from the same
             parameters and generator state, losses and parameters bit for
             bit equal; steps/s and peak memory of each, the graph's pool;
             at fit_m200 and fit_mb100k also the non-capturable Adam's
             difference from the captured run, and the same run's from
             parameters one ulp up, the fit's amplification (recorded)
  predict_mb100k  predict() over all 100,000 spots of the forced model: 1 + 16
             Gram launches (16 data-layer chunks), finite (100000, .) outputs,
             aligned error below the data's
  memory_after_fit  the bytes the fourteen cached graphs keep once fit() has
             returned, and predict_mb100k's peak reserved memory with them
             held and with them dropped; the seconds to capture one again
  resume_on_card  twins of the fit_m200 model: fit(40) against fit(20), save,
             VariationalGPSA.load, fit(20, resume_from=): losses and
             parameters bit for bit equal
  mle        WarpGPMLE at experiments/simulations/two_dimensional_mle.py's
             configuration (two views of an 8 x 8 grid, fixed warp
             variances 0.01 and lengthscales 10, view 0 fixed, 2,000 steps
             at lr 1e-2): captured, 4 Cholesky launches a step, falling
             losses, the fixed view's G its coords bit for bit, aligned
             error below the data's beside the JAX record; then a 16 x 16
             grid (512 points), 200 steps, timed; the Cholesky at their Grams
  cli        the command line on the card: fit_m200's data written to
             per-view CSVs, `python -m spatial_alignment_tpu_torch align`
             in a subprocess with fit_m200's model flags, 300 epochs and no
             --device: exit 0, the four artifacts, the manifest's generator
             on cuda, summary.json's keys, the post-alignment view MSE below
             the pre-alignment one, losses.csv bit for bit an in-process
             fit of the same model (its counters: 2 Cholesky launches a
             step); `predict` from the checkpoint alone at a 64 x 64 grid
             and at the stored coordinates against VariationalGPSA.load in
             this process (rel 1e-6); wall seconds, steps/s beside the
             in-process fit's, which optional packages the machine has
  data_host  the generators, warps, CSV loaders, k-NN filters, rotation,
             synthetic_*_like stand-ins and morans_i on the host: finite,
             of the JAX package's shapes
  parallel_world_of_one  a world of one on NCCL in this process (a file
             store under a temporary directory, make_mesh(1), distribute):
             fit_m200's model (a new one, from the constructor) as a
             distributed fit of 200 captured steps against the plain fit of
             the same seed, losses and parameters bit for bit, then 200
             more of each timed; 2 Cholesky launches and no plain call a
             step, the collectives a step (calls, bytes); then the 100k
             model (a new one) by the stratified distributed minibatch, 4 x
             250 steps of B = 4096: finite falling losses, the aligned error
             below the data's, the step's ms beside fit_mb100k's
  parallel_two_ranks  tools/parallel_probe.py in two subprocesses, gloo with
             CUDA tensors on the one card (NCCL refuses two ranks on one
             device; gloo's steps run eagerly): the 2 x 1 mesh on fit_m200's
             data (pad_multiple 2) with quad_diag_impl="pallas" (the quad
             kernels launched on each rank's rows, no plain call), the 1 x 2
             mesh (L = 10 as 5 + 5), and the 16 restarts of
             multistart_m50's harness as 8 + 8. The two meshes first hold
             one loss and backward at the start against one process at the
             same draws: the loss at rel 2e-4, every rank's gradient block
             at rtol 5e-3 and atol 1e-4 (1 + max |g|) a leaf (JAX's). Then
             20 steps each: losses against one process within rel 2e-4 or,
             where float32 spreads wider, twice the gap one ulp up opens;
             the replicated parameters bit-equal across the ranks; the
             collectives a step
  multistart_m50  fit_multistart at the JAX package's accuracy harness, full
             width (seed 0's draw, two views of 100, m = 50, 5 latent GPs;
             16 restarts of 10,000 epochs, consistency selection, top-2
             ensemble, mixed inits, accurate recipe), de-novo and template:
             every restart trained as one captured 16-wide step; the
             ensemble's aligned error held below 1/100 of the observed
             error (de-novo also below 1e-2), beside the JAX record's; the
             winner, the R-wide step's ms against one restart's, selection
             seconds
  multistart_m200, multistart_m200_pallas  fit_m200's data and model (and
             with the opt-ins), 4 restarts of 200 steps, tail-loss
             selection: each kernel launched as often a step as one
             restart's step launches it, no plain call; 50 captured R-wide
             steps against the same steps run eagerly, bit for bit; each
             restart against it alone from the same parameters and draws
             (first loss within 1e-3; over 50 steps within twice the loss
             gap one ulp up, or the non-capturable Adam, opens on the
             restarts alone); restart-steps/s against fit()'s, pool bytes
  multistart_mb100k  the 100k-spot model under set_gram_force(True):
             adaptive waves of 4 up to 8 restarts, 500 epochs a wave (the
             JAX record's 2,000 cut), consistency selection, top-2 ensemble,
             accurate recipe: every wave's launches a step as one
             restart's; the winner's and the ensemble's aligned error beside
             the data's, the selection share of the wall time
  kernels_folded  every kernel at the restart-folded shapes of the
             multistart steps (their real inputs, captured from one R-wide
             loss and gradient of each route) against its plain version,
             times beside the bound and the library call
  kernels_precision_folded  kernels_precision at the restart-folded shapes
  memory_after_multistart  fit_multistart drops its R-wide loop when it
             returns (each multistart phase records the bytes it kept,
             held near 0); here each route's R-wide loop is captured again
             and held: their pools, and predict_mb100k's peak reserved
             memory with them held and dropped
  profile    (with --profile DIR) device time per step by kernel over 10
             steps of each fit route and each multistart route's R-wide
             step, captured and eager, the device's idle share, the counters
             held against the profiler's kernel counts, and the captured
             runs' chrome traces in DIR
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
import gc
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


def capture_kernel_inputs(model, run=None):
    """The inputs the opt-in path hands each new kernel in one loss and
    gradient (forward and backward launches), one entry per distinct call
    signature, captured without changing the path. Uses the model's
    generator, as one training step does; ``run`` replaces that loss and
    gradient (an R-wide step's)."""
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
        if run is None:
            core.negative_elbo(model.spec, model.params, model.consts, model._batch, 5,
                               generator=model._gen).backward()
        else:
            run()
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


def phase_kernels(device, real_inputs, peaks, extras=True):
    """The Cholesky kernel on random well-conditioned input at the fixed
    shapes and at the shape of every real input, then on the real inputs
    (the main paths' Grams with their jitter). ``extras`` False leaves out
    the fixed shapes, the NaN contract and the autograd check (the
    restart-folded rows, whose shapes are all real inputs')."""
    import torch
    from spatial_alignment_tpu_torch.ops import cholesky as ch

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    shapes = [(2, 50, 50), (34, 50, 50), (2, 2, 200, 200), (14, 200, 200), (2, 256, 256),
              (2, 2, 384, 384), (14, 384, 384), (4, 512, 512)] if extras else []
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
    if not extras:
        return {"random_spd": list(results.values()), "real_grams": real}, results, real

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


def phase_new_kernels(device, captured, peaks, extras=True):
    """trisolve, quad_fwd, quad_bwd and factor against their plain versions
    at every shape the opt-in fits give them (``captured``: the real inputs
    of one loss and gradient of each), on those real inputs and on random
    well-conditioned input of the same shape; NaN lanes; autograd on the card
    vs the plain path on the CPU; median times beside the bound. ``extras``
    False leaves out the rows and checks at fixed shapes (identity
    right-hand side, L from global memory, NaN lanes, autograd)."""
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
            # The 3xTF32 build (the names high and highest); the path's own
            # name, and its one-pass build, are kernels_precision's.
            x, F, path_precision = args
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
                "x": list(x.shape), "F": list(F.shape), "path_precision": path_precision,
                "rel_vs_plain": rel_real,
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
            x, F, dy, path_precision = args
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
                "x": list(x.shape), "F": list(F.shape), "path_precision": path_precision,
                "rel_vs_plain": rel_real,
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
    if not extras:
        return rows

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
    exactly ``per_step`` times the steps. Peak memory is the run's largest
    allocation, and its rise above what was allocated just before (the
    fit's own: other models and their graph pools left out)."""
    import numpy as np
    import torch

    check(model.spec.svgp_solve_mode == expect_mode,
          f"{name}: solve mode {model.spec.svgp_solve_mode}, expected {expect_mode}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
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
    _, window, seen, graphs, retaken = profiled(
        lambda: model.fit(n_epochs=WINDOW_STEPS, lr=1e-2, S=S, minibatch_size=minibatch_size),
        replays=WINDOW_STEPS)
    check(seen == window and graphs == WINDOW_STEPS
          and all(window[k] == v * WINDOW_STEPS for k, v in per_step.items()),
          f"{name}: over {WINDOW_STEPS} replays the counters {window} against the "
          f"profiler's kernels {seen} and {graphs} graph launches")
    emit(name, steps=n_epochs, seconds=dt, steps_per_s=n_epochs / dt, captured=True,
         graph_pool_bytes=graph_pool_bytes(loop),
         launches=launches, launches_per_step={k: v / n_epochs for k, v in launches.items()},
         plain_calls=plain, solve_mode=model.spec.svgp_solve_mode, loss_first=float(losses[0]),
         loss_first50=first, loss_last50=last, peak_mem_bytes=peak,
         peak_mem_above_start_bytes=peak - base, minibatch_size=minibatch_size, data_chunk_size=model.spec.data_chunk_size,
         fit_calls=calls, profiler_window={"steps": WINDOW_STEPS, "launches": seen,
                                           "graph_launches": graphs, "retaken_after": retaken})
    return {"launches": launches, "losses": losses, "peak_mem_bytes": peak,
            "peak_mem_above_start_bytes": peak - base, "steps_per_s": n_epochs / dt, "graph_pool_bytes": graph_pool_bytes(loop)}


# Replays of each fit_* phase's profiler window.
WINDOW_STEPS = 3


def profiled(run, trace=None, replays=None):
    """``run()`` under torch.profiler with every count set to 0 just before:
    (device-side rows (name, self device us, count), the counters' launches
    after, the launches of the port's kernels as the profiler saw them, the
    cudaGraphLaunch calls it saw, and the first window's census when it was
    taken again, else None); the chrome trace goes to the path ``trace``
    when one is given.

    A window whose kernels disagree with the counters is taken once more
    only where the profiler is shown to have lost kernel records
    (``lost_replay_records``): ``replays`` graph replays were asked for,
    the profiler saw exactly that many cudaGraphLaunch calls, and what it
    missed of each kernel is a whole number of one replay's launches (one
    run's fit_mb100k window saw 4 of the counters' 6 Cholesky kernels and
    all 3 graph launches). The second window must agree; any other
    disagreement is the caller's to fail on."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    first = None
    while True:
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        launches, _ = read_counts()
        averages = prof.key_averages()
        # Device-side events only (kernels, copies, fills): a CPU op's row
        # repeats the device time of the kernels it launched, and a
        # device-side user annotation (the optimizer step's) spans kernels
        # listed anyway.
        rows = [(e.key, e.self_device_time_total, e.count) for e in averages
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        graphs = sum(e.count for e in averages if e.key == "cudaGraphLaunch")
        # The port's kernels by their names in csrc/; a quad backward is a
        # dx and a dF pass, or one tensor-core kernel launched twice.
        count = lambda *names: sum(r[2] for r in rows if any(n in r[0] for n in names))
        seen = {"cholesky": count("cholesky_smem_kernel", "cholesky_panel_kernel"),
                "trisolve": count("trisolve_kernel"), "quad_fwd": count("quad_fwd_kernel"),
                "quad_bwd": count("quad_bwd_tc_kernel", "quad_dx_kernel", "quad_df_kernel") / 2,
                "factor": count("factor_smem_kernel", "factor_panel_kernel"),
                "gram": count("gram_kernel")}
        if (seen == launches or first is not None
                or not lost_replay_records(launches, seen, graphs, replays)):
            break
        first = {"counters": launches, "profiler": seen, "graph_launches": graphs}
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    return rows, launches, seen, graphs, first


def lost_replay_records(launches, seen, graphs, replays) -> bool:
    """Whether the profiler, not the path, explains a window's disagreement:
    all ``replays`` graph launches of a captured run were seen, and each
    kernel's shortfall is a whole number (0 included) of one replay's
    launches, ``launches`` over ``replays``."""
    if replays is None or graphs != replays:
        return False
    for k, n in launches.items():
        per, rest = divmod(n, replays)
        missing = n - seen[k]
        if rest or missing < 0 or (missing % per if per else missing):
            return False
    return True


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
                  S: int = 5, top: int = 15, minibatch_size=None, run=None):
    """Device time of ``steps`` training steps by kernel name, from
    torch.profiler, beside the step time of ``2 * steps`` unprofiled steps
    just before it on the same model (the host's pace drifts over a run, so
    the two come from one state); the chrome trace of the captured steps
    goes to ``out_dir``. ``mode`` "captured" runs fit() (graph replays),
    "eager" the make_train_step loop; ``run(n)`` replaces either (an R-wide
    restart loop's n steps)."""
    import torch

    if run is not None:
        fit = run
    elif mode == "captured":
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
    rows, launches, by_name, graphs, retaken = profiled(
        lambda: fit(steps), trace, replays=steps if mode == "captured" else None)
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
         profiler_graph_launches=graphs, profiler_window_retaken_after=retaken,
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


# ---------------------------------------------------------------------------
# fit_multistart: R restarts trained as one captured R-wide step
# ---------------------------------------------------------------------------

# The accuracy harness of the JAX package at full width
# (experiments/simulations/accuracy_robustness.py:72-75 and
# two_dimensional_denovo_vs_templatebased.py:39-88): seed 0's draw, m = 50,
# 5 latent GPs, 16 restarts of 10,000 epochs, consistency selection, top-2
# ensemble, the mixed init families, the accurate recipe.
MS_M50 = dict(n_epochs=10_000, n_restarts=16, seed0=0, lr=1e-2, S=5, select="consistency",
              ensemble_top_k=2, init="mixed", recipe="accurate", vectorized=True, verbose=False)
# The JAX package's record of that harness over ten draws
# (experiments/out/accuracy_robustness_restarts16_consistency_init_mixed.json):
# the aligned error of ensemble_G_means_, seed 0's row and the worst draw.
MS_M50_RECORD = {"denovo": {"seed0": 5.776684265583754e-4, "worst_of_10": 2.1673948504030704e-3},
                 "template": {"seed0": 3.637002082541585e-3, "worst_of_10": 6.489298772066832e-3}}
# fit_m200's model, R = 4 restarts of 200 steps, tail-loss selection; the
# R-wide run held against each restart alone over its first 50 steps.
MS_R, MS_STEPS, MS_ALONE_STEPS = 4, 200, 50
# The 100k-spot multistart of experiments/out/multistart_scale_100k.json
# (adaptive waves of 4 up to 8 restarts, consistency selection, top-2
# ensemble, accurate recipe, B = 4096), on the forced-Gram model; cut from
# 2,000 epochs a wave to 500 so that the smoke keeps within its time.
MS_MB = dict(n_epochs=500, n_restarts=8, adaptive_waves=4, select="consistency",
             ensemble_top_k=2, recipe="accurate", lr=1e-2, S=5, minibatch_size=MB_B,
             vectorized=True, verbose=False)
MS_MB_RECORD = {"epochs_per_wave": 2000, "observed_error": 0.16752474009990692,
                "aligned_error_winner": 6.191806733113481e-06,
                "selection_share": 0.02938661311640162}


def run_multistart(model, **kw):
    """``model.fit_multistart(**kw)`` with each vectorized wave's kernel
    counts (every count set to 0 just before the wave and read just after)
    and seconds, and the seconds of selection (the aligned-coordinate
    forwards and the k-NN scores): (losses, waves, selection, seconds, the
    device bytes it kept: {"allocated_bytes", "reserved_bytes"} after it
    returned above those before it, each after gc.collect and empty_cache).
    The model must hold no R-wide loop once it returns."""
    import gc

    import torch

    cls, waves, sel = type(model), [], {"forward_s": 0.0, "consistency_s": 0.0}

    def wave(*a, **k):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = cls._fit_restarts_vectorized(model, *a, **k)
        torch.cuda.synchronize()
        launches, plain = read_counts()
        waves.append({"restarts": a[1], "steps": a[0], "seconds": time.perf_counter() - t0,
                      "launches": launches, "plain_calls": plain})
        return out

    def timed(name, key):
        def fn(*a, **k):
            t0 = time.perf_counter()
            out = getattr(cls, name)(model, *a, **k)
            torch.cuda.synchronize()
            sel[key] += time.perf_counter() - t0
            return out
        return fn

    model._fit_restarts_vectorized = wave
    model.forward = timed("forward", "forward_s")
    model._alignment_consistency = timed("_alignment_consistency", "consistency_s")
    def held():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return {"allocated_bytes": torch.cuda.memory_allocated(),
                "reserved_bytes": torch.cuda.memory_reserved()}

    try:
        before = held()
        t0 = time.perf_counter()
        losses = model.fit_multistart(**kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name in ("_fit_restarts_vectorized", "forward", "_alignment_consistency"):
            model.__dict__.pop(name, None)
    check("_vec_loop_cache" not in model.__dict__, "fit_multistart kept its R-wide loop")
    after = held()
    return losses, waves, sel, total, {k: after[k] - before[k] for k in after}


def check_waves(name, waves, per_step):
    """Every wave launched each kernel ``per_step`` times a step (the counts
    of one restart's step) and called no plain version."""
    for w in waves:
        for kernel, k in per_step.items():
            check(w["launches"][kernel] == k * w["steps"],
                  f"{name}: a wave of {w['restarts']} restarts launched "
                  f"{w['launches'][kernel]} {kernel} in {w['steps']} steps, expected {k} a step")
        check(not any(w["plain_calls"].values()),
              f"{name}: plain versions called on the card: {w['plain_calls']}")


def restart_loop_ms(loop, steps: int = 200) -> float:
    """Device-synchronized ms of one step of an R-wide loop (replays at
    temperature 0 and lr 1e-3)."""
    import numpy as np
    import torch

    lrs = np.full(steps, 1e-3, np.float32) if loop._lrs else None
    loop.run(np.zeros(steps, np.float32), lrs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run(np.zeros(steps, np.float32), lrs)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def fit_step_ms(model, steps: int = 200, **kw) -> float:
    """ms of one captured fit() step of ``model`` (a second fit of
    ``steps``, after the one that captures)."""
    import torch

    model.fit(n_epochs=steps, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(n_epochs=steps, **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def phase_multistart_m50(device):
    """The accuracy harness at full width, de-novo and template: the aligned
    error of ensemble_G_means_ beside the JAX package's record (held below
    1/100 of the observed error, and de-novo below 1e-2), the winner, the
    R-wide step's time against one restart's, and the seconds of
    selection."""
    import numpy as np
    from spatial_alignment_tpu_torch import VariationalGPSA

    dd, X, vi = two_view_data(10, 5)
    observed = aligned_error(X, vi)
    out = {}
    for mode, fixed in (("denovo", None), ("template", 0)):
        model = VariationalGPSA(dd, m_X_per_view=50, m_G=50, n_latent_gps={"expression": 5},
                                mean_function="identity_fixed", fixed_view_idx=fixed, seed=0,
                                device=device)
        losses, waves, sel, total, kept = run_multistart(model, **MS_M50)
        check(bool(np.isfinite(losses).all()), f"multistart_m50 {mode}: non-finite loss")
        check_waves(f"multistart_m50 {mode}", waves, DEFAULT_PER_STEP)
        ens = model.ensemble_G_means_["expression"]
        check(bool(np.isfinite(ens).all()), f"multistart_m50 {mode}: non-finite ensemble")
        err = aligned_error(ens, vi)
        # Below 1/100 of the observed error in both modes, and de-novo below
        # 1e-2. The template is not held at 1e-2: the JAX package itself,
        # in float32 on the CPU, ends this draw's template harness at
        # 0.0257 (tools/harness_restarts.py); its TPU record's 3.6e-3 is
        # not reproduced there.
        check(err < observed / 100 and (mode == "template" or err < 1e-2),
              f"multistart_m50 {mode}: aligned error {err} (observed {observed})")
        R, T = MS_M50["n_restarts"], MS_M50["n_epochs"]
        err_winner = aligned_error(model.predict({"expression": X})[0]["expression"], vi)
        step_ms = restart_loop_ms(restart_loop(model, MS_M50["n_restarts"], scheduled=True))
        model.__dict__.pop("_vec_loop_cache")
        single_ms = fit_step_ms(model, recipe="accurate")
        out[mode] = {
            "aligned_error_ensemble": err, "aligned_error_winner": err_winner,
            "jax_record": MS_M50_RECORD[mode], "winner": model.multistart_winner_,
            "restart_step_ms": step_ms, "restart_steps_per_s": R * 1e3 / step_ms,
            "single_step_ms": single_ms, "single_steps_per_s": 1e3 / single_ms,
            "wave_seconds": [w["seconds"] for w in waves], "selection_seconds": sel,
            "seconds": total, "kept_after_return_bytes": kept, "loss_last": float(losses[-1]),
            "launches_per_step": {k: v / T for k, v in waves[0]["launches"].items()}}
        if fixed is None:
            denovo = model
    emit("multistart_m50", observed_error=observed, restarts=MS_M50["n_restarts"],
         epochs=MS_M50["n_epochs"], **out)
    return denovo


def restart_eager(model, values, steps, S=5, lr=1e-2, seed0=0):
    """The R-wide step run eagerly from the stacked ``values`` (a fresh
    Adam, the generator reseeded with ``seed0``, as
    ``_fit_restarts_vectorized`` starts): (losses (steps, R), params, the
    draws of each step)."""
    import torch
    from spatial_alignment_tpu_torch.models import core
    from spatial_alignment_tpu_torch.models._trees import leaves, tree_map

    R = next(iter(leaves(values))).shape[0]
    params = tree_map(lambda v: v.detach().clone().requires_grad_(True), values)
    drawn = []

    def draw(R_, S_):
        drawn.append(core.draw_restart_noise(model.spec, R_, S_, model._gen, model.device))
        return drawn[-1]

    model._draw_restart_noise = draw
    try:
        loss_fn = model._restart_step_loss(S, None, R, params)
    finally:
        del model._draw_restart_noise
    opt = model._optimizer(None, lr, leaves(params))
    model._gen.manual_seed(seed0)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(1.0)
        loss.sum().backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).cpu().numpy().astype("float64"), params, drawn


def restart_single(model, values, r, drawn, S=5, lr=1e-2, ulp=False, optimizer=None):
    """Restart ``r`` alone: make_train_step from its slice of ``values``
    (``ulp``: every value one ulp up), fed restart r's slice of the R-wide
    run's draws, under ``optimizer`` (a factory; None: the capturable Adam
    fit() uses); (losses, params)."""
    import torch
    from spatial_alignment_tpu_torch.models._trees import copy_into, tree_map

    up = (lambda v: torch.nextafter(v, torch.full_like(v, math.inf))) if ulp else (lambda v: v)
    copy_into(model.params, tree_map(lambda v: up(v[r]), values))
    feed = iter(drawn)

    def draw(S_):
        wn, dn, _ = next(feed)
        return wn[r], {k: v[r] for k, v in dn.items()}

    model._draw_noise = draw
    try:
        step, _ = model.make_train_step(lr=lr, S=S, optimizer=optimizer)
    finally:
        del model._draw_noise
    losses = torch.stack([step() for _ in drawn]).cpu().numpy().astype("float64")
    return losses, [p.detach().clone() for p in model.parameters()]


def restart_runner(model, R, mode, S=5, minibatch_size=None):
    """n -> n steps of R restarts of ``model``: replays of its cached R-wide
    loop (``mode`` "captured"; a plain Adam, lr 1e-3, temperature 0), or
    the same step run eagerly."""
    import numpy as np
    from spatial_alignment_tpu_torch.models._trees import leaves, tree_map

    if mode == "captured":
        cache = model.__dict__.get("_vec_loop_cache")
        loop = cache["loop"] if cache else restart_loop(model, R, minibatch_size)
        lrs = lambda n: np.full(n, 1e-3, np.float32) if loop._lrs else None
        return lambda n: loop.run(np.zeros(n, np.float32), lrs(n))
    params = tree_map(lambda v: v.requires_grad_(True), model._restart_inits(R, 0))
    loss_fn = model._restart_step_loss(S, minibatch_size, R, params)
    opt = model._optimizer(None, 1e-3, leaves(params))

    def run(n):
        for _ in range(n):
            opt.zero_grad(set_to_none=True)
            loss_fn(0.0).sum().backward()
            opt.step()
    return run


def phase_multistart_m200(name, model, per_step, single_model):
    """fit_m200's data and model (``model``, fresh) through fit_multistart,
    R = 4 restarts of 200 steps, tail-loss selection: each kernel launched
    as often a step as one restart's step launches it, no plain call; the
    R-wide loop captured against the same step run eagerly, losses and
    parameters bit for bit; each restart of the eager R-wide run against
    that restart alone (make_train_step fed its slice of the same draws),
    over 50 steps: the first step's loss within 1e-3 (float32 in another
    summation order, the bound held between the two routes of one
    function, fit_m200_pallas against fit_m200), and the largest loss gap
    within twice the largest any restart alone shows between its run and
    the same run from parameters one ulp up, or under the non-capturable
    Adam (the fit's own amplification of a rounding difference, which the
    R-wide step's batched products make every step); restart-steps/s
    against ``single_model``'s fit() steps/s in this call, and the graph's
    pool beside the single fit's."""
    import numpy as np
    import torch
    from spatial_alignment_tpu_torch.models._trees import leaves, tree_map

    losses, waves, sel, total, kept = run_multistart(
        model, n_epochs=MS_STEPS, n_restarts=MS_R, seed0=0, lr=1e-2, S=5, select="loss",
        vectorized=True, verbose=False)
    check(bool(np.isfinite(losses).all()), f"{name}: non-finite loss")
    check(len(waves) == 1 and waves[0]["restarts"] == MS_R, f"{name}: waves {waves}")
    check_waves(name, waves, per_step)
    # fit_multistart dropped its loop; the same one, captured again, serves
    # the timing and the comparisons below.
    loop = restart_loop(model, MS_R)
    check(loop.graph is not None, f"{name}: the R-wide step was not captured")
    step_ms = restart_loop_ms(loop)
    single_ms = fit_step_ms(single_model, lr=1e-2, S=5)

    # Captured against eager: the same initial parameters and generator.
    values = model._restart_inits(MS_R, 0)
    params_c, losses_c = model._fit_restarts_vectorized(MS_ALONE_STEPS, MS_R, 0, lr=1e-2, S=5)
    params_c = tree_map(lambda t: t.detach().clone(), params_c)
    losses_e, params_e, drawn = restart_eager(model, values, MS_ALONE_STEPS)
    check(np.array_equal(losses_c.T, losses_e), f"{name}: captured R-wide losses differ from eager")
    check(all(torch.equal(a, b) for a, b in zip(leaves(params_c), leaves(params_e))),
          f"{name}: captured R-wide parameters differ from eager")
    # Each restart alone from the same parameters and draws.
    alone = []
    # The largest relative loss gap up to each of these steps.
    marks = [1, 10, 20, MS_ALONE_STEPS]
    gaps = lambda a, b: [float((np.abs(a - b) / np.abs(b))[:k].max()) for k in marks]
    noncap = lambda p: torch.optim.Adam(p, lr=1e-2)
    for r in range(MS_R):
        ls, ps = restart_single(single_model, values, r, drawn)
        lu, _ = restart_single(single_model, values, r, drawn, ulp=True)
        ln, _ = restart_single(single_model, values, r, drawn, optimizer=noncap)
        row = {"restart": r, "steps": marks, "loss_gap_vs_alone": gaps(ls, losses_e[:, r]),
               "ulp_loss_gap_alone": gaps(lu, ls), "noncapturable_loss_gap_alone": gaps(ln, ls),
               "param_rel_max": max(rel_err(a, b.detach()[r])
                                    for a, b in zip(ps, leaves(params_e)))}
        check(row["loss_gap_vs_alone"][0] <= 1e-3,
              f"{name}: restart {r}'s first loss rel {row['loss_gap_vs_alone'][0]} against it alone")
        alone.append(row)
    witness = max(max(a["ulp_loss_gap_alone"][-1], a["noncapturable_loss_gap_alone"][-1])
                  for a in alone)
    for a in alone:
        check(a["loss_gap_vs_alone"][-1] <= 2 * witness,
              f"{name}: restart {a['restart']} parts from it alone by "
              f"{a['loss_gap_vs_alone'][-1]}, rounding alone moves the restarts by {witness}")
    emit(name, restarts=MS_R, steps=MS_STEPS, captured=True,
         launches_per_step={k: v / MS_STEPS for k, v in waves[0]["launches"].items()},
         restart_step_ms=step_ms, restart_steps_per_s=MS_R * 1e3 / step_ms,
         single_step_ms=single_ms, single_steps_per_s=1e3 / single_ms,
         graph_pool_bytes=graph_pool_bytes(loop), single_graph_pool_bytes=graph_pool_bytes(
             single_model._train_loop_cache["loop"]),
         winner=model.multistart_winner_, seconds=total, wave_seconds=waves[0]["seconds"],
         kept_after_return_bytes=kept,
         captured_vs_eager_bit_equal=True, alone_steps=MS_ALONE_STEPS, restart_vs_alone=alone,
         rounding_witness=witness)
    return alone


def phase_multistart_mb100k(model, X, view_idx):
    """The 100k-spot multistart under the forced Gram kernel: every wave
    launches each kernel as one restart's step does; the winner's and the
    top-2 ensemble's aligned error beside the data's and the JAX record's,
    and the share of the wall time spent selecting."""
    import numpy as np

    with forced_gram():
        losses, waves, sel, total, kept = run_multistart(model, **MS_MB)
        G = model.predict({"expression": X})[0]["expression"]
    check(bool(np.isfinite(losses).all()), "multistart_mb100k: non-finite loss")
    check_waves("multistart_mb100k", waves, MB_GRAM_PER_STEP)
    ens = model.ensemble_G_means_["expression"]
    check(bool(np.isfinite(G).all() and np.isfinite(ens).all()),
          "multistart_mb100k: non-finite aligned coordinates")
    T = MS_MB["n_epochs"]
    emit("multistart_mb100k", waves=len(waves), restarts_scored=sum(w["restarts"] for w in waves),
         epochs_per_wave=T, launches_per_step={k: v / T for k, v in waves[0]["launches"].items()},
         observed_error=aligned_error(X, view_idx), aligned_error_winner=aligned_error(G, view_idx),
         aligned_error_top2_ensemble=aligned_error(ens, view_idx), winner=model.multistart_winner_,
         wave_seconds=[w["seconds"] for w in waves], selection_seconds=sel,
         selection_share=(sel["forward_s"] + sel["consistency_s"]) / total, seconds=total,
         kept_after_return_bytes=kept,
         jax_record=MS_MB_RECORD)


def capture_folded_inputs(model, R, S=5, minibatch_size=None):
    """The inputs one R-wide step (loss and gradient of R restarts from
    their initial parameters, the noise from a generator of the smoke's
    own) hands every kernel, the restart axis folded into their batch:
    (Cholesky inputs, [(key, stride0, args)] of the solve, quad and
    factor, Gram inputs), one per distinct call signature."""
    import torch
    from spatial_alignment_tpu_torch.models import core
    from spatial_alignment_tpu_torch.models._trees import tree_map

    ch, _, _, _, gm = kernel_modules()
    params = tree_map(lambda v: v.requires_grad_(True), model._restart_inits(R, 0))
    gen = torch.Generator(device=model.device)
    gen.manual_seed(7)
    sub = core.minibatch_spec(model.spec, minibatch_size) if minibatch_size else None
    model._draw_restart_noise = lambda R_, S_: core.draw_restart_noise(
        model.spec, R_, S_, gen, model.device, sub)
    try:
        loss_fn = model._restart_step_loss(S, minibatch_size, R, params)
    finally:
        del model._draw_restart_noise
    chol, grams, orig_c, orig_g = {}, {}, ch.cholesky_kernel, gm.gram_kernel

    def spy_c(a, *args, **kw):
        chol.setdefault(tuple(a.shape), a.detach().clone())
        return orig_c(a, *args, **kw)

    def spy_g(x1, x2, log_ls, log_var, *args, **kw):
        grams.setdefault((tuple(x1.shape), tuple(x2.shape), log_ls.numel() > 1),
                         [t.detach().clone() for t in (x1, x2, log_ls, log_var)])
        return orig_g(x1, x2, log_ls, log_var, *args, **kw)

    ch.cholesky_kernel, gm.gram_kernel = spy_c, spy_g
    try:
        others = capture_kernel_inputs(model, run=lambda: loss_fn(1.0).sum().backward())
    finally:
        ch.cholesky_kernel, gm.gram_kernel = orig_c, orig_g
    return list(chol.values()), others, list(grams.values())


# Launches a step of the whitened m = 200 model with the opt-ins: the
# Cholesky probe and the final Kuu slab (no inverse is wanted, so no fused
# factor), one width-N solve a layer and its transposed solve in the
# backward, the quad-diag forward and backward in each layer.
WHITENED_OPTIN_PER_STEP = {"cholesky": 2, "trisolve": 4, "quad_fwd": 2, "quad_bwd": 2,
                           "factor": 0, "gram": 0}
# Imputation grids: 64 x 64 over the m = 200 model's aligned coordinates,
# 250 x 200 over the 100k model's.
IMPUTE_GRIDS = {"fit_m200_whitened": (64, 64), "fit_m200_whitened_pallas": (64, 64),
                "fit_mb100k_gram_whitened": (250, 200)}


def injected_noise(model, S=5, seed=11):
    """One step's standard-normal draws for ``model``'s full batch, from a
    generator of the smoke's own: (warp_noise, data_noise)."""
    import torch

    spec, dev = model.spec, model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    Ntot = sum(m.n_padded for m in spec.modalities)
    wn = torch.randn((S, spec.n_views, Ntot, spec.n_spatial_dims), generator=gen, device=dev)
    dn = {m.name: torch.randn((S, spec.n_views * m.n_padded, m.n_latent), generator=gen,
                              device=dev) for m in spec.modalities}
    return wn, dn


def loss_at(spec, params, consts, batch, noise, S=5) -> float:
    from spatial_alignment_tpu_torch.models import core
    import torch

    with torch.no_grad():
        return float(core.negative_elbo(spec, params, consts, batch, S, warp_noise=noise[0],
                                        data_noise=noise[1]))


def triangular_first_loss(square, tri, seed=11):
    """The first loss of a triangular model and of the square model built
    from the same data and seed, at their initial parameters, from one set
    of injected draws."""
    noise = injected_noise(square, seed=seed)
    a = loss_at(square.spec, square.params, square.consts, square._batch, noise)
    b = loss_at(tri.spec, tri.params, tri.consts, tri._batch, noise)
    return {"square": a, "triangular": b, "rel": abs(b - a) / abs(a)}


def to_whitened(model, dtype):
    """``model``'s square-mode parameters as whitened ones for the same q, on
    the host in float64: w = L^-1 (delta - mu_z), A = L^-1 chol(Omega). L
    and chol(Omega) are the model's own factors in ``dtype`` (float32: on
    the card, with the jitter rung the float32 model takes; float64: on the
    CPU), then solved in float64. Returns (params, consts) in ``dtype`` on
    the device the factors were taken on."""
    import torch
    from spatial_alignment_tpu_torch.models._trees import tree_map
    from spatial_alignment_tpu_torch.ops import linalg
    from spatial_alignment_tpu_torch.ops.kernels import get_kernel

    spec = model.spec
    dev = model.device if dtype == torch.float32 else torch.device("cpu")
    cast = lambda t: t.detach().to(dev, dtype)
    params, consts = tree_map(cast, model.params), tree_map(cast, model.consts)
    hp = {**consts, **params}
    eps = spec.diagonal_offset
    kw, kd = get_kernel(spec.kernel_warp), get_kernel(spec.kernel_data)
    f64 = lambda t: t.detach().cpu().double()
    solve = lambda L, b: torch.linalg.solve_triangular(L, b, upper=False)
    with torch.no_grad():
        Xt = hp["Xtilde"]
        Lw = f64(torch.stack([linalg.jittered_cholesky(kw(
            Xt[v], Xt[v], hp["warp_kernel_lengthscales"][v], hp["warp_kernel_variances"][v]),
            eps) for v in range(spec.n_views)]))
        Lf = f64(linalg.jittered_cholesky(kd(hp["Gtilde"], hp["Gtilde"],
                                             hp["data_kernel_lengthscale"],
                                             hp["data_kernel_variance"]), eps))
        mu_z = f64(Xt @ hp["mean_slopes"] + hp["mean_intercepts"][:, None])
        out = dict(params)
        out["delta_G"] = solve(Lw, f64(hp["delta_G"]) - mu_z)
        C = f64(linalg.factor_psd_cholesky(hp["Omega_sqt_G"], eps))
        out["Omega_sqt_G"] = solve(Lw[:, None], C)
        out["delta_F"] = {k: solve(Lf, f64(v)) for k, v in hp["delta_F"].items()}
        out["Omega_sqt_F"] = {k: solve(Lf, f64(linalg.factor_psd_cholesky(v, eps)))
                              for k, v in hp["Omega_sqt_F"].items()}
        out = tree_map(lambda t: t.to(dev, dtype), out)
    return out, consts


def phase_variational_equivalence(tri_rows, square_fit, noise_seed=12):
    """The parameterizations against each other at full width, from
    injected draws. Triangular (``tri_rows``, from ``triangular_first_loss``
    before any training): a triangular model's first loss against the square
    model of the same seed (its stored factor is the float64 Cholesky of the
    square mode's initial covariance, so both hold one q; rel 1e-4, where
    the card's float32 Cholesky of the square mode's covariance parts from
    the float64 one by rounding times its condition number).
    Whitened: ``square_fit``'s trained square parameters converted to
    whitened ones (``to_whitened``), the two losses in float64 on the CPU
    (the same function: held at 1e-9) and in float32 on the card (1e-4:
    the two parameterizations reach the same q through other float32
    factors and solves)."""
    import torch

    for name, row in tri_rows.items():
        check(row["rel"] <= 1e-4, f"{name}: triangular first loss rel {row['rel']}")
    m = square_fit
    spec_w = m.spec.replace(whitened_variational=True)
    rows = {}
    for dtype in (torch.float64, torch.float32):
        pw, consts = to_whitened(m, dtype)
        dev = next(iter(consts.values())).device
        params = {k: ({kk: vv.detach().to(dev, dtype) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.detach().to(dev, dtype))
                  for k, v in m.params.items()}
        batch = {mod: {k: (t.to(dev, dtype) if t.is_floating_point() else t.to(dev))
                       for k, t in b.items()} for mod, b in m._batch.items()}
        wn, dn = injected_noise(m, seed=noise_seed)
        noise = (wn.to(dev, dtype), {k: v.to(dev, dtype) for k, v in dn.items()})
        t0 = time.perf_counter()
        a = loss_at(m.spec, params, consts, batch, noise)
        b = loss_at(spec_w, pw, consts, batch, noise)
        key = "float64_cpu" if dtype == torch.float64 else "float32_card"
        rows[key] = {"square": a, "whitened": b, "rel": abs(b - a) / abs(a),
                     "seconds": time.perf_counter() - t0}
    check(rows["float64_cpu"]["rel"] <= 1e-9,
          f"whitened equivalence float64: rel {rows['float64_cpu']['rel']}")
    check(rows["float32_card"]["rel"] <= 1e-4,
          f"whitened equivalence float32: rel {rows['float32_card']['rel']}")
    emit("variational_equivalence", triangular_first_loss=tri_rows, whitened_from_fit_m200=rows)


def capture_with_generator_kept(model, fn):
    """``fn(model)`` with the model's generator state put back after, so a
    capture leaves the model's first training step its own draws."""
    state = model._gen.get_state()
    try:
        return fn(model)
    finally:
        model._gen.set_state(state)


def phase_variational_kernels(device, peaks, models, impute):
    """Every kernel at the shapes the triangular and whitened routes give
    it, captured from one loss and gradient of each model (``models``:
    {name: model}) before it trains: the Cholesky's Kuu-only slabs, the
    width-N solves of the whitened opt-in model, the fused factor of the
    triangular opt-in one; and the quad forward of ``impute`` = (name,
    model, X): forward(G_test=) on that opt-in model at its
    ``IMPUTE_GRIDS`` grid over X's bounding box. Each against its plain
    version, timed beside the bound and the library call."""
    import torch

    chol, others = {}, {}
    for name, model in models.items():
        def one(m, mb=name.startswith("fit_mb100k")):
            if mb:
                with forced_gram():
                    return minibatch_loss(m, MB_B)
            return full_loss(m)

        for a in capture_with_generator_kept(model, lambda m: capture_cholesky_inputs(
                lambda: one(m))):
            chol.setdefault(tuple(a.shape), a)
        if model.spec.cholesky_impl == "pallas":
            keep = "trisolve" if model.spec.whitened_variational else "factor"
            for key, stride0, args in capture_with_generator_kept(model, capture_kernel_inputs):
                if key == keep:
                    sig = (key,) + tuple(tuple(t.shape) if torch.is_tensor(t) else t
                                         for t in args)
                    others.setdefault(sig, (key, stride0, args))
    imp_name, imp_model, X_imp = impute
    grid = impute_grid(X_imp, IMPUTE_GRIDS[imp_name])
    run = lambda m: capture_kernel_inputs(m, run=lambda: m.forward(
        {"expression": X_imp}, S=5, G_test={"expression": grid}))
    imp = [(key, stride0, args) for key, stride0, args in
           capture_with_generator_kept(imp_model, run)
           if key == "quad_fwd" and args[0].shape[-2] == len(grid)]
    check([(tuple(a[0].shape), tuple(a[1].shape)) for _, _, a in imp]
          == [((1, len(grid), 200), (10, 200, 200))],
          f"{imp_name}: imputation quad forward inputs "
          f"{[[tuple(a.shape) for a in i[2] if torch.is_tensor(a)] for i in imp]}")
    others[("quad_fwd_impute",)] = imp[0]
    new_chol = {s: a for s, a in chol.items() if s in ((2, 200, 200), (2, 100, 100))}
    check(sorted(new_chol) == [(2, 100, 100), (2, 200, 200)],
          f"Kuu-only Cholesky slabs {sorted(chol)}")
    # The data layer's factor reaches the kernel expanded over the 5
    # samples with stride 0 (one factor shared); the warp layer's is its own.
    want = sorted([("trisolve", (5, 200, 200), (5, 200, 4050), False, True),
                   ("trisolve", (5, 200, 200), (5, 200, 4050), True, True),
                   ("trisolve", (1, 200, 200), (1, 200, 2025), False, False),
                   ("trisolve", (1, 200, 200), (1, 200, 2025), True, False)])
    got = sorted(k[:4] + (v[1],) for k, v in others.items() if k[0] == "trisolve")
    check(got == want, f"whitened solve shapes {got}, expected {want}")
    check([k[1] for k in others if k[0] == "factor"] == [(2, 200, 200)],
          f"triangular fused factor shapes {[k for k in others if k[0] == 'factor']}")
    record, _, _ = phase_kernels(device, list(new_chol.values()), peaks, extras=False)
    rows = phase_new_kernels(device, list(others.values()), peaks, extras=False)
    emit("kernels_variational", cholesky=record, trisolve=rows["trisolve"], factor=rows["factor"],
         quad_fwd_impute=rows["quad_fwd"])
    return rows


def impute_grid(G, shape):
    """A grid of shape[0] x shape[1] points over the bounding box of G."""
    import numpy as np

    lo, hi = G.min(0), G.max(0)
    g0, g1 = np.meshgrid(np.linspace(lo[0], hi[0], shape[0]), np.linspace(lo[1], hi[1], shape[1]))
    return np.stack([g0.ravel(), g1.ravel()], 1).astype(np.float32)


def phase_impute(name, model, X, view_idx, S=5, forced=False):
    """forward(G_test=) on a grid over the aligned coordinates' bounding box
    (``IMPUTE_GRIDS``; ``forced``: under the forced Gram kernel, as the
    model trained): finite (S, n, L) and (S, n, P) samples, seconds and
    peak memory, and the launches G_test adds to the same forward without
    it: one quad forward on the opt-in route, none elsewhere (impute_at's
    cross-Gram and solves take no kernel opt-in). Then imputation at one
    view's own aligned means, with the noise zeroed
    (``core.impute_at(noise=0)``): the imputed observed means against
    predict()'s F_mean at those points, both through the expansion form of
    the cross-Gram (predict's S-batched, impute_at's not; rel 1e-5, or ten
    times the data factor's condition number times float32's unit
    roundoff where predict's solves run the CUDA kernel and impute_at's
    the plain one)."""
    import numpy as np
    import torch
    from spatial_alignment_tpu_torch.models import core
    from spatial_alignment_tpu_torch.models.params import merge_hyperparams

    mod = model.spec.modalities[0]
    G, F_mean, _ = (d["expression"] for d in model.predict({"expression": X}))
    grid = impute_grid(G, IMPUTE_GRIDS[name])
    with forced_gram() if forced else contextlib.nullcontext():
        reset_counts()
        model.forward({"expression": X}, S=S)
        torch.cuda.synchronize()
        without, _ = read_counts()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = model.forward({"expression": X}, S=S, G_test={"expression": grid})
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches, plain = read_counts()
        added = {k: n - without[k] for k, n in launches.items()}
        want = {**dict.fromkeys(added, 0),
                "quad_fwd": int(model.spec.quad_diag_impl == "pallas")}
        check(added == want and not any(plain.values()),
              f"{name}: forward(G_test=) added launches {added}, expected {want}; plain {plain}")
        lat, obs = out[4]["expression"], out[5]["expression"]
        check(len(out) == 6 and lat.shape == (S, len(grid), mod.n_latent)
              and obs.shape == (S, len(grid), mod.n_outputs),
              f"{name}: forward(G_test=) gave {len(out)} outputs, {lat.shape}, {obs.shape}")
        check(bool(np.isfinite(lat).all() and np.isfinite(obs).all()),
              f"{name}: non-finite imputation")
    v = 1
    Gv = torch.as_tensor(G[view_idx[v]], device=model.device)
    hp = merge_hyperparams(model.params, model.consts)
    with torch.no_grad():
        fp = core.compute_factors(model.spec, hp)
        aux = core.DataAux(fp.data_Kuu_chol, fp.data_Om_tril, fp.data_Kuu_inv)
        zero = {mod.name: torch.zeros((1, len(Gv), mod.n_latent), device=model.device)}
        _, imp = core.impute_at(model.spec, hp, aux, {mod.name: Gv}, 1, noise=zero)
    mean = imp[mod.name][0].cpu().numpy()
    want = F_mean[view_idx[v]]
    rel = float(np.abs(mean - want).max() / np.abs(want).max())
    tol = 1e-5
    if model.spec.cholesky_impl == "pallas":
        tol = max(tol, 10 * cond2(fp.data_Kuu_chol) * 2.0**-24)
    check(rel <= tol, f"{name}: imputed means at view {v}'s aligned means rel {rel} vs "
                      f"predict (tolerance {tol})")
    emit("impute", fit=name, grid=list(IMPUTE_GRIDS[name]), n_test=len(grid), S=S, seconds=dt,
         peak_mem_bytes=peak, latent_shape=list(lat.shape), observed_shape=list(obs.shape),
         launches_added_by_G_test=added, imputed_vs_predict_view=v,
         imputed_vs_predict_rel=rel, imputed_vs_predict_tolerance=tol)


def restart_loop(model, R, minibatch_size=None, scheduled=False):
    """The model's R-wide train loop, captured again if fit_multistart has
    dropped it: plain Adam at lr 1e-2 and S = 5 (``scheduled``: the
    recipe's CosineDecayAdam), from the restarts' initial parameters."""
    from spatial_alignment_tpu_torch.models.train import CosineDecayAdam

    opt = CosineDecayAdam(1e-2, 1) if scheduled else None
    return model._restart_loop(R, 1e-2, 5, opt, minibatch_size, model._restart_inits(R, 0))


def phase_memory_after_multistart(models, predict):
    """What fit_multistart's R-wide loops would keep were they not dropped
    when it returns (each captured again here, ``models``: {name: (model,
    R, minibatch_size, scheduled)}): their pools, predict_mb100k's peak
    reserved memory with them held and after they are dropped."""
    import gc

    import torch

    pools = {}
    for name, (model, R, mb, scheduled) in models.items():
        ctx = forced_gram() if mb else contextlib.nullcontext()
        with ctx:
            pools[name] = graph_pool_bytes(restart_loop(model, R, mb, scheduled))
    out = {}
    for state in ("held", "dropped"):
        if state == "dropped":
            for model, *_ in models.values():
                model.__dict__.pop("_vec_loop_cache", None)
            gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        predict()
        torch.cuda.synchronize()
        out[state] = {"reserved_bytes": reserved,
                      "predict_peak_reserved_bytes": torch.cuda.max_memory_reserved()}
    emit("memory_after_multistart", restart_graph_pool_bytes=pools,
         restart_graph_pools_total_bytes=sum(pools.values()), **out)


# ---------------------------------------------------------------------------
# The precision names on the card (models with >= 2,000 points resolve to
# svgp_matmul_precision "high" and svgp_variance_precision "default").
# ---------------------------------------------------------------------------

HIGHEST = dict(svgp_matmul_precision="highest", svgp_variance_precision="highest")


# Relative error of one product of two operands rounded to TF32 (nearest:
# 2^-11 each) or truncated to it (2^-10 each, which cuBLAS may do), and of
# the 3xTF32 split (lo * lo dropped, lo read as TF32: about 2^-21).
QUAD_PRODUCT_ERR = {"tf32": 2.0**-10 + 2.0**-22, "tf32_truncated": 2.0**-9 + 2.0**-20,
                    "3xtf32": 2.0**-20}


def error_bounds(x, F, dy, mode: str = "tf32"):
    """Exact values in float64 and first-order bounds on the error of a
    forward and backward whose products carry ``QUAD_PRODUCT_ERR[mode]`` each,
    summed in float32 (each of the K terms of a sum off by up to K 2^-23,
    which allows truncating adds). For x (G, N, m), F (L, m, m) or
    (G, L, m, m), dy (G, L, N): ((out, out_bound), (dx, dx_bound),
    (dF, dF_bound)), every one float64 of its output's shape.

    t = x F_b is off by e_t = (u + (m + 2) 2^-23) |x| |F_b|; the output
    sum_k t_k^2 by sum_k (2 |t_k| e_k + e_k^2) plus its own float32 sum; w =
    2 dy t by 2 |dy| e_t, and the second products by u on each term plus
    their float32 sums over L m (dx) or the factor's G N rows (dF), each
    with 64 more for the blocks' partial sums. The bound the quad kernels
    are held to (``kernels_precision``, ``tests/test_torch_cuda.py``).
    """
    import torch

    u = QUAD_PRODUCT_ERR[mode]
    x64, F64, dy64 = x.double(), F.double(), dy.double()
    xa, Fa = x64.abs(), F64.abs()
    G, N, m = x.shape
    L = F.shape[-3]
    sum_err = lambda k: (k + 2) * 2.0**-23
    t = x64.unsqueeze(1) @ F64  # (G, L, N, m)
    e_t = (u + sum_err(m)) * (xa.unsqueeze(1) @ Fa)
    out = t.square().sum(-1)
    out_b = (2 * t.abs() * e_t + e_t.square()).sum(-1) + sum_err(m) * out
    d2 = 2 * dy64.abs().unsqueeze(-1)
    w = 2 * dy64.unsqueeze(-1) * t
    w_abs = d2 * (t.abs() + e_t)
    e_w = d2 * e_t + u * w_abs
    Ft = Fa.transpose(-1, -2)
    dx = (w @ F64.transpose(-1, -2)).sum(1)
    dx_b = (e_w @ Ft).sum(1) + sum_err(L * m + 64) * (w_abs @ Ft).sum(1)
    eq, rows = ("gni,gbnk->gbik", N) if F.dim() == 4 else ("gni,gbnk->bik", G * N)
    dF = torch.einsum(eq, x64, w)
    dF_b = torch.einsum(eq, xa, e_w) + sum_err(rows + 64) * torch.einsum(eq, xa, w_abs)
    return (out, out_b), (dx, dx_b), (dF, dF_b)


def tf32_flags():
    """PyTorch's process-wide TF32 flags, as they read."""
    import torch

    mm = torch.backends.cuda.matmul
    return {"allow_tf32": mm.allow_tf32, "float32_matmul_precision":
            torch.get_float32_matmul_precision(),
            "fp32_precision": getattr(mm, "fp32_precision", None)}


# The cases of the first loss and gradients: the constructor's parameters
# (fit_m200's own model) and every warp and data lengthscale set to 0.3 and
# to 1.0 (the data lie on [0, 10]^2; the constructor's warp lengthscale is 10).
PRECISION_CASES = ("init", 0.3, 1.0)
# The loss is held to rel 1e-3 between the names in every case. A leaf's
# gradient is held to rel 1e-2 (max-norm) wherever float32 resolves it: where
# the card's float32 gradient at highest lies within FLOOR_HELD of the float64
# one, a tenth of the limit. Where it does not, the float64 computation is
# the only reference, and the gap of each name to it is recorded.
LOSS_LIMIT, GRAD_LIMIT, FLOOR_HELD = 1e-3, 1e-2, 1e-3


def first_loss_grads(model, spec, noise, device, dtype, S=5):
    """One loss and its gradients of ``model``'s parameters under ``spec`` and
    the injected draws ``noise``, on ``device`` in ``dtype`` (float64 on the
    CPU: the plain versions): (loss, {leaf: gradient in float64 on the
    CPU}). The model's own tensors are left as they were."""
    import torch
    from spatial_alignment_tpu_torch.models import core
    from spatial_alignment_tpu_torch.models._trees import named_leaves, tree_map

    move = lambda tree: tree_map(lambda t: t.detach().to(device, dtype)
                                 if t.is_floating_point() else t.to(device), tree)
    params = move(model.params)
    for _, leaf in named_leaves(params):
        leaf.requires_grad_(True)
    wn = noise[0].to(device, dtype)
    dn = {k: v.to(device, dtype) for k, v in noise[1].items()}
    loss = core.negative_elbo(spec, params, move(model.consts), move(model._batch), S,
                              warp_noise=wn, data_noise=dn)
    loss.backward()
    return float(loss.detach()), {k: v.grad.double().cpu() for k, v in named_leaves(params)}


def precision_first_rows(name, model, reference=None, cases=PRECISION_CASES, hold=True,
                         S=5, seed=13):
    """The loss and gradients of ``model`` (names resolved to high/default)
    against the same model with both names at ``highest``, at the same
    parameters and injected draws, before it trains, and both against the
    float64 computation on the CPU, in each of ``cases``. With ``hold``: the
    loss within LOSS_LIMIT, and the gradient of each leaf whose highest
    gradient lies within FLOOR_HELD of float64 within GRAD_LIMIT. The
    parameters are put back after. ``reference`` holds the float64 results
    of a model with the same parameters (the opt-in twin's are the default
    model's: one function, other kernels), checked bit-equal before use;
    returns (rows, reference)."""
    import torch
    from spatial_alignment_tpu_torch.models._trees import named_leaves

    check((model.spec.svgp_matmul_precision, model.spec.svgp_variance_precision)
          == ("high", "default"), f"{name}: names {model.spec.svgp_matmul_precision}, "
                                  f"{model.spec.svgp_variance_precision}")
    noise = injected_noise(model, S, seed)
    names = ("warp_kernel_lengthscales", "data_kernel_lengthscale")
    saved = {k: model.params[k].detach().clone() for k in names}
    hi_spec = model.spec.replace(**HIGHEST)
    rel = lambda a, b: {k: rel_err(a[k], b[k]) for k in b}
    reference = {} if reference is None else reference
    rows = {}
    for case in cases:
        with torch.no_grad():
            for k in names:
                model.params[k].copy_(saved[k] if case == "init"
                                      else torch.full_like(saved[k], math.log(case)))
        loss, grads = first_loss_grads(model, model.spec, noise, model.device, torch.float32, S)
        loss_hi, grads_hi = first_loss_grads(model, hi_spec, noise, model.device,
                                             torch.float32, S)
        here = {k: v.detach().to("cpu", copy=True) for k, v in named_leaves(model.params)}
        if case not in reference:
            t0 = time.perf_counter()
            reference[case] = (here, *first_loss_grads(model, hi_spec, noise, "cpu",
                                                       torch.float64, S),
                               time.perf_counter() - t0)
        params64, loss64, grads64, seconds64 = reference[case]
        check(all(bit_equal(here[k], params64[k]) for k in params64),
              f"{name} ({case}): parameters differ from the float64 reference's")
        grad_rel, floor = rel(grads, grads_hi), rel(grads_hi, grads64)
        held = sorted(k for k in floor if floor[k] <= FLOOR_HELD)
        loss_rel = abs(loss - loss_hi) / abs(loss_hi)
        if hold:
            check(loss_rel <= LOSS_LIMIT,
                  f"{name} ({case}): default vs highest loss rel {loss_rel}")
            check(all(grad_rel[k] <= GRAD_LIMIT for k in held),
                  f"{name} ({case}): default vs highest gradient rel {grad_rel} "
                  f"on the leaves float32 resolves ({held}; highest vs float64 {floor})")
        worst = max(held, key=grad_rel.get) if held else None
        rows[str(case)] = {
            "loss": loss, "loss_highest": loss_hi, "loss_float64": loss64,
            "loss_rel": loss_rel, "grad_rel": grad_rel, "highest_vs_float64": floor,
            "default_vs_float64": rel(grads, grads64), "held_leaves": held,
            "grad_rel_max_held": grad_rel[worst] if held else None,
            "grad_rel_max_held_leaf": worst, "float64_seconds": seconds64}
    with torch.no_grad():
        for k, v in saved.items():
            model.params[k].copy_(v)
    return rows, reference


def tensor_core_gemm(name: str) -> bool:
    """Whether a cuBLAS float32 GEMM kernel runs on the tensor cores (TF32):
    its name says tf32 (``sm90_xmma_gemm_f32f32_tf32f32_f32...``) or is a
    CUTLASS tensor-op kernel (``cutlass_80_tensorop_s1688gemm...``: m16n8k8
    TF32 mma); fp32 ones are ``..._ffma_...`` or ``cutlass_80_simt_sgemm``."""
    name = name.lower()
    return "tf32" in name or "tensorop" in name


def gemm_census(model, steps=2):
    """The GEMM kernels of ``steps`` replays of ``model``'s captured fit step
    by the profiler: {name: (device ms a step, launches a step)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import torch

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.fit(n_epochs=steps, lr=1e-2, S=5)
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "gemm" in e.key.lower()}


def largest_gemms(census, n=3):
    """The kernel names of the ``n`` GEMM launches of a step with the most
    device time (a name counted once a launch, by its mean time)."""
    out = []
    for name, (ms, count) in sorted(census.items(), key=lambda kv: -kv[1][0] / kv[1][1]):
        out += [name] * int(round(count))
    return out[:n]


def phase_precision(first_rows, fits, models, flags_before, vi200, X200):
    """What the names compute on the card at fit_m200's model: the first
    loss and gradients against the highest twin (``first_rows``, default
    and opt-in routes), each route's 200-step fit beside its twin's (aligned
    error, both held below the data's; captured step ms, in turns after the
    fits; ``models`` holds the four by name), the GEMMs of a captured step by the
    profiler (the default route's variance products in TF32 kernels, none in
    the twin's), and PyTorch's TF32 flags as they were before the fits."""
    census = {name: gemm_census(models[name]) for name in ("fit_m200", "fit_m200_highest")}
    tf32 = {name: {k: v for k, v in c.items() if tensor_core_gemm(k)} for name, c in census.items()}
    per_step = {name: sum(n for _, n in t.values()) for name, t in tf32.items()}
    largest = {name: largest_gemms(c) for name, c in census.items()}
    # The three large products of a step (the data layer's t and both of its
    # backward products) run TF32 kernels at default and fp32 ones at highest;
    # no product of the twin runs on the tensor cores.
    check(all(tensor_core_gemm(k) for k in largest["fit_m200"])
          and not any(tensor_core_gemm(k) for k in largest["fit_m200_highest"])
          and per_step["fit_m200"] >= 3 and per_step["fit_m200_highest"] == 0,
          f"precision: largest GEMMs {largest}; tensor-core GEMM launches a step {per_step}")
    top = lambda c: sorted(c.items(), key=lambda kv: -kv[1][0])[:5]
    flags_after = tf32_flags()
    check(flags_after == flags_before, f"precision: TF32 flags {flags_before} -> {flags_after}")
    routes = {}
    for name in ("fit_m200", "fit_m200_pallas"):
        fit, twin_ = fits[name], fits[name + "_highest"]
        err_data = aligned_error(X200, vi200)
        for n_, f in ((name, fit), (name + "_highest", twin_)):
            check(bool(f["aligned_error"] < err_data),
                  f"{n_}: aligned error {err_data} -> {f['aligned_error']}")
        # Captured steps after the fits, in turns (A B B A), 100 steps each.
        ms = {n_: [] for n_ in (name, name + "_highest")}
        for n_ in (name, name + "_highest", name + "_highest", name):
            ms[n_].append(fit_step_ms(models[n_], 100, lr=1e-2, S=5))
        step_ms = {n_: sum(v) / len(v) for n_, v in ms.items()}
        routes[name] = {"step_ms": step_ms[name], "step_ms_highest": step_ms[name + "_highest"],
                        "step_ms_runs": ms, "speedup": step_ms[name + "_highest"] / step_ms[name],
                        "fit_steps_per_s_with_capture": fit["steps_per_s"],
                        "fit_steps_per_s_with_capture_highest": twin_["steps_per_s"],
                        "aligned_error": fit["aligned_error"],
                        "aligned_error_highest": twin_["aligned_error"],
                        "aligned_error_data": err_data,
                        "loss_last50": float(fit["losses"][-50:].mean()),
                        "loss_last50_highest": float(twin_["losses"][-50:].mean())}
    emit("precision", first=first_rows, routes=routes, flags_before=flags_before,
         flags_after=flags_after, tf32_gemm_launches_per_step=per_step,
         largest_gemms=largest,
         gemm_ms_per_step={name: sum(t for t, _ in c.values()) for name, c in census.items()},
         top_gemms={name: [(k, t, n) for k, (t, n) in top(c)] for name, c in census.items()})


def phase_kernels_precision(captured, peaks, phase="kernels_precision"):
    """The quad kernels' one-pass TF32 build (``default``) on the inputs the
    opt-in fits hand them at that name (``captured``: (key, stride0, args)
    with the name last): against float64 within :func:`error_bounds`
    (operands rounded to TF32, 2^-11 each: about 2^-10 a product, float32
    sums), against the plain version at ``default`` (cuBLAS TF32, which may
    truncate: 2^-10 an operand) within the sum of both bounds, two launches
    bit-equal; times of the kernel, of the 3xTF32 build, of the plain
    version at default, of one cuBLAS TF32 call making t (forward), beside
    the one-pass bound (the products once at the TF32 peak)."""
    import torch
    from spatial_alignment_tpu_torch.ops import precision, quad

    rows = {"quad_fwd": [], "quad_bwd": []}
    seen = set()
    for key, _, args in captured:
        if key not in rows or args[-1] != "default":
            continue
        sig = (key,) + tuple(tuple(a.shape) for a in args[:-1])
        if sig in seen:
            continue
        seen.add(sig)
        x, F = args[0], args[1]
        G, N, m = x.shape
        Lc = F.shape[-3]
        dy = args[2] if key == "quad_bwd" else torch.randn(
            (G, Lc, N), generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")
        bounds = error_bounds(x, F, dy, "tf32")
        bounds_p = error_bounds(x, F, dy, "tf32_truncated")
        if key == "quad_fwd":
            run = lambda: (quad.quad_fwd_kernel(x, F, "default"),)
            plain = (quad.quad_diag_plain(x, F, "default"),)
            bounds, bounds_p = bounds[:1], bounds_p[:1]
            products = 1
        else:
            run = lambda: quad.quad_bwd_kernel(x, F, dy, "default")
            plain = quad.quad_bwd_plain(x, F, dy, "default")
            bounds, bounds_p = bounds[1:], bounds_p[1:]
            products = 3
        got, again = run(), run()
        torch.cuda.synchronize()
        ratio_f64, ratio_plain, max_abs = [], [], []
        for k, a, p, (exact, b), (_, bp) in zip(got, again, plain, bounds, bounds_p):
            check(bool(torch.isfinite(k).all()), f"{phase} {key} {tuple(x.shape)}: non-finite")
            check(bit_equal(k, a), f"{phase} {key} {tuple(x.shape)}: two launches differ")
            ratio_f64.append(float(((k.double() - exact).abs() / b).max()))
            ratio_plain.append(float(((k.double() - p.double()).abs() / (b + bp)).max()))
            max_abs.append(float((k - p).abs().max()))
        check(max(ratio_f64) <= 1.0 and max(ratio_plain) <= 1.0,
              f"{phase} {key} {tuple(x.shape)}: error / bound vs float64 {ratio_f64}, "
              f"vs plain {ratio_plain}")
        rels = [rel_err(k.double(), exact) for k, (exact, _) in zip(got, bounds)]
        del bounds, bounds_p
        torch.cuda.empty_cache()
        n_bytes = 4 * (x.numel() + F.numel() + (G * Lc * N if key == "quad_fwd"
                                                 else dy.numel() + x.numel() + F.numel()))
        b1, by = bound_ms(n_bytes, products * 2 * G * N * Lc * m * m, peaks, peaks[2])
        b3, _ = bound_ms(n_bytes, 3 * products * 2 * G * N * Lc * m * m, peaks, peaks[2])
        n = 20 if key == "quad_fwd" else 30
        row = {"x": list(x.shape), "F": list(F.shape), "products": "1xTF32 mma.sync m16n8k8",
               "error_over_bound_vs_float64": ratio_f64,
               "error_over_bound_vs_plain": ratio_plain, "rel_vs_float64": rels,
               "max_abs_err": max(max_abs), "bit_equal_twice": True,
               "kernel_ms": median_ms(lambda: run(), n=n),
               "kernel_3xtf32_ms": median_ms(
                   (lambda: quad.quad_fwd_kernel(x, F)) if key == "quad_fwd"
                   else (lambda: quad.quad_bwd_kernel(x, F, dy)), n=n),
               "plain_ms": median_ms(
                   (lambda: quad.quad_diag_plain(x, F, "default")) if key == "quad_fwd"
                   else (lambda: quad.quad_bwd_plain(x, F, dy, "default")), n=n),
               "library_ms": (median_ms(lambda: precision.matmul(x.unsqueeze(1), F, "default"))
                              if key == "quad_fwd" else None),
               "library": ("torch.matmul in cuBLAS TF32 producing t only"
                           if key == "quad_fwd" else None),
               "bound_ms": b1, "bound_by": by, "bound_3xtf32_ms": b3}
        if key == "quad_bwd":
            row["design"] = quad.bwd_design(G, N, m, Lc, G if F.dim() == 4 else 1, "default")
        rows[key].append(row)
    check(rows["quad_fwd"] and rows["quad_bwd"], f"{phase}: no quad inputs at default")
    emit(phase, **rows)
    return rows


# ---------------------------------------------------------------------------
# WarpGPMLE at the reference experiment's configuration
# (experiments/simulations/two_dimensional_mle.py: two views of an 8 x 8
# grid, 10 outputs, fixed warp variances 0.01 and lengthscales 10, view 0
# fixed, 2,000 epochs of Adam at lr 1e-2), then at a 16 x 16 grid (512
# points: the data Gram's Cholesky in the panel design).
# ---------------------------------------------------------------------------

MLE_RECORD = {"pre": 0.06638024473850464, "post_mle": 0.005463987588882446,
              "source": "experiments/out/mle_vs_variational.json (the JAX package)"}
# Cholesky launches a step: the warp slab (V, N_pad, N_pad) and the data
# matrix (N_total, N_total), each after its jitter probe (one launch: from
# m = 64 the probe's two rungs are stacked).
MLE_CHOLESKY_PER_STEP = 4


def mle_run(device, grid_size, n_epochs, hold):
    """One WarpGPMLE fit at ``grid_size``: finite losses, the Cholesky
    kernel's launches a step, no plain call, a captured step and the fixed
    view's G bit for bit its coords; with ``hold`` also falling losses and
    an aligned error below the data's. Returns (row, the Grams one loss
    hands the Cholesky)."""
    import numpy as np
    import torch
    from spatial_alignment_tpu_torch import WarpGPMLE
    from spatial_alignment_tpu_torch.data import generate_twod_data

    X, Y, nsl, vi = generate_twod_data(
        2, 10, grid_size=grid_size, n_latent_gps=None, kernel_variance=0.1,
        kernel_lengthscale=5.0, noise_variance=1e-3, fixed_view_idx=0,
        rng=np.random.default_rng(0))
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    dd = {"expression": {"spatial_coords": X, "outputs": Y, "n_samples_list": nsl}}
    model = WarpGPMLE(dd, fixed_warp_kernel_variances=np.ones(2) * 0.01,
                      fixed_warp_kernel_lengthscales=np.ones(2) * 10.0, fixed_view_idx=0,
                      seed=0, device=device)
    inputs = capture_cholesky_inputs(lambda: model.loss_fn())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    losses = model.fit(n_epochs=n_epochs, lr=1e-2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain = read_counts()
    name = f"mle_grid{grid_size}"
    check(bool(np.isfinite(losses).all()), f"{name}: non-finite loss")
    window = min(50, n_epochs // 4)
    first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
    check(not hold or last < first, f"{name}: loss did not fall ({first} -> {last})")
    check(launches["cholesky"] == MLE_CHOLESKY_PER_STEP * n_epochs
          and not any(v for k, v in launches.items() if k != "cholesky")
          and not any(plain.values()),
          f"{name}: launches {launches} for {n_epochs} steps, plain {plain}")
    check(model._loop.graph is not None, f"{name}: fit() did not capture its step")
    G = model.G["expression"]
    check(np.array_equal(G[vi[0]], X[vi[0]]), f"{name}: the fixed view moved")
    pre, post = aligned_error(X, vi), aligned_error(G, vi)
    check(not hold or post < pre, f"{name}: aligned error {pre} -> {post}")
    return {"points": int(X.shape[0]), "steps": n_epochs, "seconds": dt,
            "steps_per_s": n_epochs / dt, "captured": True,
            "cholesky_launches_per_step": launches["cholesky"] / n_epochs,
            "cholesky_shapes": [list(a.shape) for a in inputs],
            "loss_first": float(losses[0]), "loss_first50": first, "loss_last50": last,
            "loss_final": float(losses[-1]), "fixed_view_bit_equal": True,
            "aligned_error_data": pre, "aligned_error_fit": post}, inputs


def phase_mle(device, peaks):
    """WarpGPMLE through its entry points at the reference experiment's
    size (held: falling losses, aligned error below the data's), then 200
    steps at 512 points (timed; its alignment is reported, not held: 200
    steps are a tenth of the reference's length), and the Cholesky kernel
    at the shapes both hand it (their real Grams, captured from one loss)."""
    ref, inputs = mle_run(device, 8, 2000, hold=True)
    big, inputs_big = mle_run(device, 16, 200, hold=False)
    record, _, _ = phase_kernels(device, inputs + inputs_big, peaks, extras=False)
    emit("mle", reference_config=ref, grid16=big, jax_record=MLE_RECORD,
         cholesky=record)
    return record


# The keys of the JAX package's summary.json (spatial_alignment_tpu/cli.py).
CLI_SUMMARY_KEYS = ["n_views", "n_samples_list", "n_outputs", "epochs", "final_neg_elbo",
                    "train_seconds", "pre_alignment_view_mse", "post_alignment_view_mse",
                    "artifacts"]
CLI_EPOCHS = 300


def run_cli(args, out_log):
    """``python -m spatial_alignment_tpu_torch`` in a subprocess from the
    checkout, with no --device (the card): (wall seconds, its stdout). Its
    output goes into the phase's record, not this script's stdout."""
    import os

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "spatial_alignment_tpu_torch", *args],
                          cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    out_log.append({"args": args[:1], "rc": done.returncode,
                    "stdout_tail": done.stdout[-600:], "stderr_tail": done.stderr[-1500:]})
    check(done.returncode == 0, f"cli {args[0]}: exit {done.returncode}: {done.stderr[-1500:]}")
    return wall, done.stdout


def write_view_csvs(d: Path, dd):
    """Each view of ``dd`` as the command line reads it: coordinates under an
    x,y header, counts under a gene header with a spot index column, every
    float32 at 9 significant digits (exact in float32)."""
    import numpy as np

    X, Y = dd["expression"]["spatial_coords"], dd["expression"]["outputs"]
    cs = np.insert(np.cumsum(dd["expression"]["n_samples_list"]), 0, 0)
    args = []
    for v in range(len(cs) - 1):
        cpath, ypath = d / f"view{v}_xy.csv", d / f"view{v}_counts.csv"
        np.savetxt(cpath, X[cs[v]:cs[v + 1]], delimiter=",", header="x,y", comments="",
                   fmt="%.9g")
        n = cs[v + 1] - cs[v]
        np.savetxt(ypath, np.column_stack([np.arange(n), Y[cs[v]:cs[v + 1]]]), delimiter=",",
                   header=",".join(["spot"] + [f"g{j}" for j in range(Y.shape[1])]),
                   comments="", fmt=["%d"] + ["%.9g"] * Y.shape[1])
        args += ["--coords", str(cpath), "--counts", str(ypath)]
    return args


def phase_cli(dd200, kw200, epochs=CLI_EPOCHS):
    """The command line on the card: ``align`` on fit_m200's data written to
    per-view CSVs, with the flags that give fit_m200's model and no
    --device; its losses.csv against an in-process fit of the same model
    from the same seed, bit for bit (that fit's counters show the Cholesky
    launches, so the command line ran the main path and its kernel); then
    ``predict`` from the checkpoint alone, at a 64 x 64 grid and at the
    stored coordinates, against ``VariationalGPSA.load(...).predict`` in
    this process within rel 1e-6."""
    import importlib.util
    import json as json_
    import numpy as np
    import torch
    from spatial_alignment_tpu_torch import VariationalGPSA
    from spatial_alignment_tpu_torch.data import load_csv_expression

    X, Y = dd200["expression"]["spatial_coords"], dd200["expression"]["outputs"]
    nsl = dd200["expression"]["n_samples_list"]
    logs, row = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        views = write_view_csvs(d, dd200)
        for v in range(len(nsl)):
            x, y = load_csv_expression(views[4 * v + 1], views[4 * v + 3])
            lo = sum(nsl[:v])
            check(np.array_equal(x.astype(np.float32), X[lo:lo + nsl[v]])
                  and np.array_equal(y.astype(np.float32), Y[lo:lo + nsl[v]]),
                  f"cli: view {v}'s CSVs do not carry its float32 data exactly")
        out = d / "out"
        wall, _ = run_cli(["align", *views, "--m", str(kw200["m_G"]),
                           "--n-latent-gps", str(kw200["n_latent_gps"]["expression"]),
                           "--template", str(kw200["fixed_view_idx"]),
                           "--mean-function", kw200["mean_function"],
                           "--epochs", str(epochs), "--print-every", "100",
                           "--out", str(out)], logs)
        row["align_wall_seconds"] = wall
        arts = sorted(p.name for p in out.iterdir())
        check(arts == ["aligned_coords.csv", "losses.csv", "model.npz", "model.npz.json",
                       "summary.json"], f"cli align: artifacts {arts}")
        manifest = json_.loads((out / "model.npz.json").read_text())
        check(manifest.get("torch_rng_device") == "cuda",
              f"cli align: manifest torch_rng_device {manifest.get('torch_rng_device')}")
        summary = json_.loads((out / "summary.json").read_text())
        check(list(summary) == CLI_SUMMARY_KEYS, f"cli align: summary keys {list(summary)}")
        pre, post = summary["pre_alignment_view_mse"], summary["post_alignment_view_mse"]
        check(math.isfinite(summary["final_neg_elbo"]) and post < pre,
              f"cli align: final loss {summary['final_neg_elbo']}, view mse {pre} -> {post}")
        losses_cli = np.loadtxt(out / "losses.csv", skiprows=1)
        check(losses_cli.shape == (epochs,), f"cli align: losses.csv {losses_cli.shape}")
        aligned = np.loadtxt(out / "aligned_coords.csv", delimiter=",", skiprows=1)
        check(aligned.shape == (sum(nsl), 5), f"cli align: aligned_coords {aligned.shape}")

        # The in-process twin: the command line's defaults (lr 1e-2, S = 5,
        # plain recipe) on the same data, model and seed.
        twin_model = VariationalGPSA(dd200, **kw200)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        losses = twin_model.fit(epochs, lr=1e-2, S=5, print_every=100, recipe="plain")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches, plain = read_counts()
        check(np.array_equal(losses_cli, losses),
              f"cli align: losses.csv differs from the in-process fit at "
              f"{int(np.sum(losses_cli != losses))} of {epochs} steps "
              f"(first {np.flatnonzero(losses_cli != losses)[:3].tolist()})")
        check(launches["cholesky"] == DEFAULT_PER_STEP["cholesky"] * epochs
              and not any(plain.values()),
              f"cli twin: launches {launches}, plain {plain}")

        # predict from the checkpoint alone: a 64 x 64 grid, then the stored
        # training coordinates.
        ax = np.linspace(0.0, 10.0, 64)
        g1, g2 = np.meshgrid(ax, ax)
        grid = np.stack([g1.ravel(), g2.ravel()], 1).astype(np.float32)
        np.savetxt(d / "grid.csv", grid, delimiter=",", header="x,y", comments="", fmt="%.9g")
        model = VariationalGPSA.load(str(out / "model.npz"))
        n_g = grid.shape[0]
        cases = {
            "at_grid": (["--at", str(d / "grid.csv")], (2 * n_g, Y.shape[1]),
                        lambda: model.predict(
                            {"expression": np.tile(grid, (2, 1))},
                            {"expression": [np.arange(v * n_g, (v + 1) * n_g)
                                            for v in range(2)]})),
            "stored": ([], (sum(nsl), Y.shape[1]), lambda: model.predict({"expression": X})),
        }
        for name, (extra, shape, local) in cases.items():
            dest = d / f"pred_{name}"
            wall, _ = run_cli(["predict", "--checkpoint", str(out / "model.npz"), *extra,
                               "--out", str(dest)], logs)
            mu = np.loadtxt(dest / "pred_mean.csv", delimiter=",")
            var = np.loadtxt(dest / "pred_var.csv", delimiter=",")
            G = np.loadtxt(dest / "aligned_coords.csv", delimiter=",", skiprows=1)
            check(mu.shape == shape and var.shape == shape and G.shape == (shape[0], 2),
                  f"cli predict {name}: shapes {mu.shape}, {var.shape}, {G.shape}")
            check(bool(np.isfinite(mu).all() and np.isfinite(G).all() and (var > 0).all()),
                  f"cli predict {name}: non-finite mean or non-positive variance")
            G_l, F_l, V_l = (np.asarray(o["expression"], np.float64) for o in local())
            rels = {k: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) for k, a, b in
                    (("aligned", G, G_l), ("mean", mu, F_l), ("var", var, V_l))}
            check(max(rels.values()) <= 1e-6,
                  f"cli predict {name}: against the in-process load, rel {rels}")
            row[f"predict_{name}"] = {"wall_seconds": wall, "shape": list(shape),
                                      "rel_vs_in_process": rels}
    cli_steps = epochs / summary["train_seconds"]
    emit("cli", epochs=epochs, train_seconds=summary["train_seconds"],
         steps_per_s=cli_steps, in_process_fit_seconds=fit_s,
         in_process_steps_per_s=epochs / fit_s, losses_bit_equal=True,
         in_process_launches=launches, final_neg_elbo=summary["final_neg_elbo"],
         pre_alignment_view_mse=pre, post_alignment_view_mse=post,
         torch_rng_device=manifest["torch_rng_device"], **row,
         importable={m: importlib.util.find_spec(m) is not None
                     for m in ("h5py", "matplotlib", "pandas", "sklearn")},
         subprocesses=logs)


# The distributed fits of the parallel phases: fit_m200's steps, and the
# 100k model's 4 x 250 minibatch steps.
PAR_STEPS = 200


def phase_parallel_world_of_one(dd200, kw200, fit200, ddm, vim, fit_mb):
    """A world of one on NCCL in this process: fit_m200's model as a
    distributed fit against the plain fit bit for bit, with its launches,
    collectives and step time; then the 100k model's stratified distributed
    minibatch fit. The process group is destroyed when it returns."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from spatial_alignment_tpu_torch import VariationalGPSA, ops
    from spatial_alignment_tpu_torch.parallel import distribute, make_mesh

    def collectives(c, steps):
        return {k.split(".", 1)[1]: v / steps for k, v in c.items()
                if k.startswith("collectives.") and v}

    def timed_fit(model, n, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = model.fit(n_epochs=n, lr=1e-2, S=5, **kw)
        torch.cuda.synchronize()
        return losses, (time.perf_counter() - t0) * 1e3 / n

    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        plain = VariationalGPSA(dd200, **kw200)
        model = distribute(twin(plain), mesh)
        want, _ = timed_fit(plain, PAR_STEPS)
        reset_counts()
        got, _ = timed_fit(model, PAR_STEPS)
        c = ops.read_counters()
        launches, plain_calls = read_counts()
        loop = model._train_loop_cache["loop"]
        same = all(torch.equal(a, b) for a, b in zip(model.parameters(), plain.parameters()))
        check(loop.graph is not None, "parallel_world_of_one: the distributed fit was not captured")
        check(bool(np.array_equal(got, want)) and same,
              "parallel_world_of_one: distributed losses or parameters differ from the plain "
              f"fit's (largest loss gap {float(np.max(np.abs(got - want)))})")
        check(launches["cholesky"] == 2 * PAR_STEPS and not any(plain_calls.values()),
              f"parallel_world_of_one: {launches} launches, plain calls {plain_calls}")
        coll = collectives(c, PAR_STEPS)
        check(coll.get("all_reduce_world_calls") == 2 and set(coll) == {
            "all_reduce_world_calls", "all_reduce_world_bytes"},
            f"parallel_world_of_one: collectives a step {coll}")
        # 200 more steps of each, timed on their cached loops (both captured)
        want2, plain_ms = timed_fit(plain, PAR_STEPS)
        got2, dist_ms = timed_fit(model, PAR_STEPS)
        check(bool(np.array_equal(got2, want2)),
              "parallel_world_of_one: the second fit's losses differ")
        row200 = {"steps": 2 * PAR_STEPS, "captured": True, "losses_bit_equal": True,
                  "params_bit_equal": True, "launches_per_step": {
                      k: v / PAR_STEPS for k, v in launches.items()},
                  "collectives_per_step": coll, "ms_per_step": dist_ms,
                  "plain_ms_per_step": plain_ms,
                  "fit_m200_ms_per_step": 1e3 / fit200["steps_per_s"],
                  "graph_pool_bytes": graph_pool_bytes(loop),
                  "loss_first": float(got[0]), "loss_last": float(got2[-1])}
        del plain, model, loop

        # The 100k model by the stratified distributed minibatch (a new one).
        mb = distribute(VariationalGPSA(ddm, **MB100K, device="cuda"), mesh)
        observed = aligned_error(ddm["expression"]["spatial_coords"], vim)
        reset_counts()
        runs = [timed_fit(mb, MB_STEPS // MB_CALLS, minibatch_size=MB_B) for _ in range(MB_CALLS)]
        c = ops.read_counters()
        launches, plain_calls = read_counts()
        losses = np.concatenate([r[0] for r in runs])
        first, last = float(losses[:50].mean()), float(losses[-50:].mean())
        err = aligned_error(mb.predict({"expression": ddm["expression"]["spatial_coords"]})[0][
            "expression"], vim)
        check(bool(np.isfinite(losses).all()) and last < first,
              f"parallel_world_of_one mb100k: losses {first} -> {last}")
        check(err < observed, f"parallel_world_of_one mb100k: aligned error {err} >= {observed}")
        check(launches["cholesky"] == 2 * MB_STEPS and not any(plain_calls.values()),
              f"parallel_world_of_one mb100k: {launches} launches, plain calls {plain_calls}")
        check(mb._train_loop_cache["loop"].graph is not None,
              "parallel_world_of_one mb100k: not captured")
        rowmb = {"steps": MB_STEPS, "fit_calls": MB_CALLS, "minibatch_size": MB_B,
                 "stratified": True, "loss_first50": first, "loss_last50": last,
                 "aligned_error": err, "aligned_error_data": observed,
                 "launches_per_step": {k: v / MB_STEPS for k, v in launches.items()},
                 "collectives_per_step": collectives(c, MB_STEPS),
                 "ms_per_step_last_call": runs[-1][1],
                 "fit_mb100k_ms_per_step": 1e3 / fit_mb["steps_per_s"]}
        del mb
    finally:
        gc.collect()
        dist.destroy_process_group()
    emit("parallel_world_of_one", backend="nccl", fit_m200=row200, mb100k=rowmb)


def phase_parallel_two_ranks():
    """tools/parallel_probe.py in two subprocesses on gloo with CUDA tensors
    on this card (the probe holds each case and exits non-zero on a failed
    check); its rank 0's JSON record."""
    import os

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = lambda r: [sys.executable, str(ROOT / "tools" / "parallel_probe.py"), "--rank", str(r),
                     "--world", "2", "--store", str(tmp / "store"), "--out", str(tmp / "out"),
                     "--cases", "data2,model2,restarts2"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd(r), cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"parallel_two_ranks: rank {r} exit {p.returncode}: {err[-3000:]}")
    record = json.loads(outs[0][0].strip().splitlines()[-1])
    check(set(record["cases"]) == {"data2", "model2", "restarts2"} and record["backend"] == "gloo",
          f"parallel_two_ranks: {record}")
    for case in ("data2", "model2"):
        row = record["cases"][case]
        check(row["grad0_worst_ratio"] <= 1.0 and max(row["loss0_rel"]) <= 2e-4,
              f"parallel_two_ranks {case}: the start's loss or gradients against one process")
    quad = record["cases"]["data2"]["launches_per_step"]
    check(quad.get("quad.fwd_launches", 0) > 0 and quad.get("quad.bwd_launches", 0) > 0
          and not quad.get("quad.plain_calls"),
          f"parallel_two_ranks data2: quad-diag kernels on the distributed path: {quad}")
    emit("parallel_two_ranks", wall_seconds=wall, **record)


def phase_data_host(dd200):
    """Every host-side function of ``data/`` and the repaired ``morans_i``
    on this machine's Python (no pandas, no sklearn needed): each result
    finite and of the JAX package's shape."""
    import numpy as np
    from spatial_alignment_tpu_torch import data
    from spatial_alignment_tpu_torch.utils.metrics import morans_i

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    ax = np.linspace(0, 10, 20)
    g1, g2 = np.meshgrid(ax, ax)
    grid = np.stack([g1.ravel(), g2.ravel()], 1)
    out = {}

    def hold(name, arrays, shapes):
        got = [tuple(np.shape(a)) for a in arrays]
        check(got == shapes, f"data_host {name}: shapes {got}, expected {shapes}")
        check(all(np.isfinite(np.asarray(a, np.float64)).all() for a in arrays),
              f"data_host {name}: non-finite values")
        out[name] = [list(s) for s in got]

    X, Y, nsl, _ = data.generate_oned_data_affine_warp(2, 3, 100, rng=rng)
    hold("generate_oned_data_affine_warp", [X, Y], [(200, 1), (200, 3)])
    X, Y, nsl, _ = data.generate_oned_data_gp_warp(2, 2, 100, n_latent_gps=1, rng=rng)
    hold("generate_oned_data_gp_warp", [X, Y], [(200, 1), (200, 2)])
    X, Y, nsl, _ = data.generate_twod_data(2, 30, 20, n_latent_gps=5, fixed_view_idx=0, rng=rng)
    hold("generate_twod_data", [X, Y], [(800, 2), (800, 30)])
    X, Y, nsl, _, keep = data.generate_twod_data_partial_overlap(2, 10, 20, rng=rng)
    n_keep = int(keep.sum())
    hold("generate_twod_data_partial_overlap", [X, Y], [(400 + n_keep, 2), (400 + n_keep, 10)])
    Y0 = np.sin(grid)
    X, Y, _, _ = data.apply_gp_warp(grid, Y0, 3, noise_variance=0.01, rng=rng)
    hold("apply_gp_warp", [X, Y], [(1200, 2), (1200, 2)])
    Xs, Ys, _, _ = data.apply_gp_warp_multimodal([grid[:150], grid[150:]], [Y0[:150], Y0[150:]],
                                                 2, rng=rng)
    hold("apply_gp_warp_multimodal", [*Xs, *Ys], [(300, 2), (500, 2), (300, 2), (500, 2)])
    X, Y, _, _ = data.apply_linear_warp(grid, Y0, 2, rng=rng)
    hold("apply_linear_warp", [X, Y], [(800, 2), (800, 2)])
    X, Y, _, _ = data.apply_polar_warp(grid, Y0, 2, rng=rng)
    hold("apply_polar_warp", [X, Y], [(800, 2), (800, 2)])

    X200, Y200 = (np.asarray(dd200["expression"][k], np.float64)
                  for k in ("spatial_coords", "outputs"))
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        views = write_view_csvs(d, dd200)
        x, y = data.load_csv_expression(views[1], views[3])
        hold("load_csv_expression", [x, y], [(2025, 2), (2025, 30)])
        paths = []
        for s in range(2):
            labels = [f"{i}x{j}" for i in range(15) for j in range(15)]
            counts = rng.poisson(3.0, (225, 40 - s))
            path = d / f"st{s}.csv"
            with open(path, "w") as f:
                f.write(",".join([""] + [f"G{k + s}" for k in range(40 - s)]) + "\n")
                for lab, r in zip(labels, counts):
                    f.write(",".join([lab] + [str(v) for v in r]) + "\n")
            paths.append(str(path))
        coords, counts, names = data.load_st_data(paths, n_genes=20)
        hold("load_st_data", [*coords, *counts], [(225, 2)] * 2 + [(225, 20)] * 2)
    keep = data.knn_r2_gene_filter(X200, Y200, 10)
    hold("knn_r2_gene_filter", [keep], [(10,)])
    mask = data.remove_outlier_spots(X200)
    hold("remove_outlier_spots", [mask], [(4050,)])
    hold("rotate_coords", [data.rotate_coords(X200, 20.0)], [(4050, 2)])
    for name, fn, shapes in (
            ("synthetic_visium_like", data.synthetic_visium_like, [(800, 2)] * 2 + [(800, 50)] * 2),
            ("synthetic_slideseq_like", data.synthetic_slideseq_like,
             [(3000, 2)] * 2 + [(3000, 30)] * 2),
            ("synthetic_st_like", data.synthetic_st_like, [(144, 2)] * 4 + [(144, 40)] * 4)):
        c, y = fn()
        hold(name, [*c, *y], shapes)
    I = morans_i(X200[:2025], Y200[:2025, :5])
    hold("morans_i", [I], [(5,)])
    emit("data_host", seconds=time.perf_counter() - t0, shapes=out,
         morans_i_first_view=np.asarray(I).tolist(), knn_r2_top=keep.tolist(),
         outliers_removed=int((~mask).sum()))


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

    flags_before = tf32_flags()
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
    # Its whitened twin, from the constructor: the same data, seed and
    # k-means centres, the whitened init.
    model_mb_w = VariationalGPSA(ddm, **MB100K, whitened_variational=True, device=device)

    dd200, X200, vi200 = two_view_data(45, 10)
    kw200 = dict(m_X_per_view=200, m_G=200, n_latent_gps={"expression": 10}, fixed_view_idx=0,
                 mean_function="identity_fixed", device=device)
    model = VariationalGPSA(dd200, **kw200)
    # Its twin with both precision names at highest (fp32 in cuBLAS,
    # 3xTF32 in the quad kernels): the same data, seed and parameters.
    model_hi = VariationalGPSA(dd200, **kw200, **HIGHEST)
    first_rows, float64_first = {}, None
    first_rows["fit_m200"], float64_first = precision_first_rows("fit_m200", model)
    # The Cholesky's inputs on both main paths: one loss of the m = 200 model
    # from its generator (as its first step, and as its opt-in twin's capture
    # below), and one minibatch loss of the 100k model from a generator of
    # its own (its twins keep the same generator state).
    # The m = 384 model: fit_m200's data with more inducing points, where the
    # Cholesky and the fused factor leave shared memory for their panel
    # designs (m > 240).
    kw384 = {**kw200, "m_X_per_view": 384, "m_G": 384}
    model384 = VariationalGPSA(dd200, **kw384)
    # The triangular and whitened twins of the m = 200 model (the
    # constructor's, from the same data and seed), and the m = 50 pair; the
    # triangular first losses are taken here, before anything trains.
    model_tri = VariationalGPSA(dd200, **kw200, triangular_variational=True)
    model_tri_p = VariationalGPSA(dd200, **kw200, **OPT_INS, triangular_variational=True)
    model_w = VariationalGPSA(dd200, **kw200, whitened_variational=True)
    model_w_p = VariationalGPSA(dd200, **kw200, **OPT_INS, whitened_variational=True)
    dd50, X50, vi50 = two_view_data(10, None)
    kw50 = dict(m_X_per_view=50, m_G=50, n_latent_gps={"expression": None}, fixed_view_idx=0,
                device=device)
    model50 = VariationalGPSA(dd50, **kw50)
    model50_tri = VariationalGPSA(dd50, **kw50, triangular_variational=True)
    tri_rows = {"m200": triangular_first_loss(model, model_tri),
                "m50": triangular_first_loss(model50, model50_tri)}
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
    model_p_hi = VariationalGPSA(dd200, **kw200, **OPT_INS, **HIGHEST)
    first_rows["fit_m200_pallas"], _ = precision_first_rows("fit_m200_pallas", model_p,
                                                            float64_first)
    del float64_first
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
    prec_record = phase_kernels_precision(captured, peaks)
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
    phase_variational_kernels(device, peaks, {
        "fit_m200_triangular": model_tri, "fit_m200_triangular_pallas": model_tri_p,
        "fit_m200_whitened_pallas": model_w_p, "fit_mb100k_gram_whitened": model_mb_w},
        ("fit_m200_whitened_pallas", model_w_p, X200))
    del model_tri_p

    G_pre, _, _ = model.predict({"expression": X200})
    fit200 = phase_fit("fit_m200", model, 200, 5, "mixed", DEFAULT_PER_STEP)
    fit200["aligned_error"] = aligned_error(model.predict({"expression": X200})[0]["expression"],
                                            vi200)
    fit50 = phase_fit("fit_m50", model50, 300, 5, "kl_inverse", DEFAULT_PER_STEP)
    fit50["aligned_error"] = aligned_error(model50.predict({"expression": X50})[0]["expression"],
                                           vi50)
    fit200_p = phase_fit("fit_m200_pallas", model_p, 200, 5, "mixed", OPTIN_PER_STEP)
    fit200_p["aligned_error"] = aligned_error(
        model_p.predict({"expression": X200})[0]["expression"], vi200)
    # The same function from the same parameters and noise: the first
    # losses agree to float32 summation order.
    first_rel = abs(fit200_p["losses"][0] - fit200["losses"][0]) / abs(fit200["losses"][0])
    check(first_rel <= 1e-3, f"fit_m200_pallas: first loss rel {first_rel} vs fit_m200")
    emit("fit_m200_pallas_vs_fit_m200", first_loss_rel=first_rel)
    # The twins at highest: the same 200 steps, then the precision phase.
    fits_prec = {"fit_m200": fit200, "fit_m200_pallas": fit200_p}
    for name_, mdl, per_step in (("fit_m200_highest", model_hi, DEFAULT_PER_STEP),
                                 ("fit_m200_pallas_highest", model_p_hi, OPTIN_PER_STEP)):
        fits_prec[name_] = phase_fit(name_, mdl, 200, 5, "mixed", per_step)
        fits_prec[name_]["aligned_error"] = aligned_error(
            mdl.predict({"expression": X200})[0]["expression"], vi200)
    phase_precision(first_rows, fits_prec,
                    {"fit_m200": model, "fit_m200_highest": model_hi,
                     "fit_m200_pallas": model_p, "fit_m200_pallas_highest": model_p_hi},
                    flags_before, vi200, X200)
    del model_hi, model_p_hi, fits_prec
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

    # The triangular and whitened routes: bench.py's fourth key (m = 50,
    # triangular, kl_inverse) and the m = 200 model in both modes, the
    # whitened one also with the opt-ins (width-N solves). Each route's
    # aligned error is read just after its fit. At m = 50 the first 300
    # steps leave it above the data's in the square fit too (fit50 above),
    # so that route's alignment is held after 700 steps more.
    variational = {}
    for name_, mdl, steps, mode, per_step, square, X_, vi_ in (
            ("fit_m50_triangular", model50_tri, 300, "kl_inverse", DEFAULT_PER_STEP, fit50,
             X50, vi50),
            ("fit_m200_triangular", model_tri, 200, "mixed", DEFAULT_PER_STEP, fit200, X200,
             vi200),
            ("fit_m200_whitened", model_w, 200, "mixed", DEFAULT_PER_STEP, fit200, X200, vi200),
            ("fit_m200_whitened_pallas", model_w_p, 200, "mixed", WHITENED_OPTIN_PER_STEP,
             fit200_p, X200, vi200)):
        fit = phase_fit(name_, mdl, steps, 5, mode, per_step)
        fit["aligned_error"] = aligned_error(mdl.predict({"expression": X_})[0]["expression"],
                                             vi_)
        variational[name_] = (fit, square, mdl, X_, vi_)
    fit = variational["fit_m50_triangular"][0]
    model50_tri.fit(n_epochs=700, lr=1e-2, S=5)
    fit["aligned_error_after_1000_steps"] = aligned_error(
        model50_tri.predict({"expression": X50})[0]["expression"], vi50)
    fits_w = [variational[k][0] for k in ("fit_m200_whitened_pallas", "fit_m200_whitened")]
    rel_w = abs(fits_w[0]["losses"][0] - fits_w[1]["losses"][0]) / abs(fits_w[1]["losses"][0])
    check(rel_w <= 1e-3, f"fit_m200_whitened_pallas: first loss rel {rel_w} vs fit_m200_whitened")
    emit("fit_m200_whitened_pallas_vs_fit_m200_whitened", first_loss_rel=rel_w)
    phase_variational_equivalence(tri_rows, model)
    phase_impute("fit_m200_whitened", model_w, X200, vi200)
    phase_impute("fit_m200_whitened_pallas", model_w_p, X200, vi200)
    for name_, (_, _, mdl, _, _) in variational.items():
        phase_graph_vs_eager(name_, mdl)

    # The 100k-spot minibatch fits, default route and forced Gram kernel.
    fit_mb = phase_fit("fit_mb100k", model_mb, MB_STEPS, 5, "mixed", DEFAULT_PER_STEP, MB_B,
                       MB_CALLS)
    with forced_gram():
        fit_mb_g = phase_fit("fit_mb100k_gram", model_mb_g, MB_STEPS, 5, "mixed",
                             MB_GRAM_PER_STEP, MB_B, MB_CALLS)
        fit_mb_g["aligned_error"] = aligned_error(
            model_mb_g.predict({"expression": Xm})[0]["expression"], vim)
        fit_mb_gc = phase_fit("fit_mb100k_gram_chunked", model_mb_gc, 100, 5, "mixed",
                              MB_GRAM_CHUNKED_PER_STEP, MB_B)
        fit_mb_w = phase_fit("fit_mb100k_gram_whitened", model_mb_w, MB_STEPS, 5, "mixed",
                             MB_GRAM_PER_STEP, MB_B, MB_CALLS)
        fit_mb_w["aligned_error"] = aligned_error(
            model_mb_w.predict({"expression": Xm})[0]["expression"], vim)
    variational["fit_mb100k_gram_whitened"] = (fit_mb_w, fit_mb_g, model_mb_w, Xm, vim)
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
        phase_graph_vs_eager("fit_mb100k_gram_whitened", model_mb_w, minibatch_size=MB_B)

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

    phase_impute("fit_mb100k_gram_whitened", model_mb_w, Xm, vim, forced=True)
    # Each triangular and whitened route beside its square-mode twin of this
    # run: steps/s, peak memory above the fit's start, the graph's pool; the
    # aligned error just after each fit (the route's held below the data's;
    # at m = 50 after 1,000 steps).
    rows = {}
    for name_, (fit, square, mdl, X_, vi_) in variational.items():
        err_data = aligned_error(X_, vi_)
        held = fit.get("aligned_error_after_1000_steps", fit["aligned_error"])
        check(bool(np.isfinite(held)) and held < err_data,
              f"{name_}: aligned error {err_data} -> {held}")
        rows[name_] = {"steps_per_s": fit["steps_per_s"], "square_steps_per_s": square["steps_per_s"],
                       "peak_mem_above_start_bytes": fit["peak_mem_above_start_bytes"],
                       "square_peak_mem_above_start_bytes":
                           square["peak_mem_above_start_bytes"],
                       "graph_pool_bytes": fit["graph_pool_bytes"],
                       "square_graph_pool_bytes": square["graph_pool_bytes"],
                       "aligned_error_data": err_data,
                       **{k: fit[k] for k in ("aligned_error", "aligned_error_after_1000_steps")
                          if k in fit},
                       "square_aligned_error": square["aligned_error"]}
    emit("variational_routes", routes=rows)

    def predict_mb100k():
        with forced_gram():
            return model_mb_g.predict({"expression": Xm})

    phase_memory_after_fit(
        {"fit_m200": model, "fit_m50": model50, "fit_m200_pallas": model_p,
         "fit_m50_pallas": model50_p, "fit_m384": model384, "fit_m384_pallas": model384_p,
         "fit_mb100k": model_mb, "fit_mb100k_gram": model_mb_g,
         "fit_mb100k_gram_chunked": model_mb_gc,
         **{name_: v[2] for name_, v in variational.items()}},
        predict_mb100k, (model_mb, 1e-2, 5, None, MB_B))
    phase_resume(model)
    phase_mle(device, peaks)
    # The command line and the host-side data functions, after every fit_*
    # phase: fit_m200's data and model through `python -m
    # spatial_alignment_tpu_torch align` / `predict`.
    phase_cli(dd200, kw200)
    phase_data_host(dd200)
    # The distributed path: a world of one on NCCL here, then two ranks on
    # gloo in subprocesses.
    phase_parallel_world_of_one(dd200, kw200, fit200, ddm, vim, fit_mb)
    phase_parallel_two_ranks()

    # fit_multistart, after every fit_* phase (its single-restart runs
    # overwrite the m = 200 models' parameters): the harness at m = 50, the
    # m = 200 routes against one restart alone, the 100k-spot adaptive waves,
    # then every kernel at the restart-folded shapes of their steps.
    model_ms50 = phase_multistart_m50(device)
    model_ms = VariationalGPSA(dd200, **kw200)
    model_ms_p = VariationalGPSA(dd200, **kw200, **OPT_INS)
    phase_multistart_m200("multistart_m200", model_ms, DEFAULT_PER_STEP, model)
    phase_multistart_m200("multistart_m200_pallas", model_ms_p, OPTIN_PER_STEP, model_p)
    phase_multistart_mb100k(model_mb_g, Xm, vim)
    chol, new, grams = {}, {}, {}
    for mdl, R, mb in ((model_ms, MS_R, None), (model_ms_p, MS_R, None),
                       (model_ms50, MS_M50["n_restarts"], None),
                       (model_mb_g, MS_MB["adaptive_waves"], MB_B)):
        with forced_gram() if mdl is model_mb_g else contextlib.nullcontext():
            c, o, g = capture_folded_inputs(mdl, R, minibatch_size=mb)
        for a in c:
            chol.setdefault(tuple(a.shape), a)
        for key, stride0, a in o:
            new.setdefault((key,) + tuple(tuple(t.shape) if torch.is_tensor(t) else t for t in a),
                           (key, stride0, a))
        for x in g:
            grams.setdefault((tuple(x[0].shape), tuple(x[1].shape), x[2].numel() > 1), x)
    folded_chol, _, _ = phase_kernels(device, list(chol.values()), peaks, extras=False)
    emit("kernels_folded", cholesky=folded_chol,
         **phase_new_kernels(device, list(new.values()), peaks, extras=False),
         **phase_gram(device, list(grams.values()), peaks))
    phase_kernels_precision(list(new.values()), peaks, "kernels_precision_folded")
    phase_memory_after_multistart(
        {"multistart_m50": (model_ms50, MS_M50["n_restarts"], None, True),
         "multistart_m200": (model_ms, MS_R, None, False),
         "multistart_m200_pallas": (model_ms_p, MS_R, None, False),
         "multistart_mb100k": (model_mb_g, MS_MB["adaptive_waves"], MB_B, True)},
        predict_mb100k)

    if args.profile is not None:
        for mode in ("captured", "eager"):
            phase_profile("fit_m200", model, args.profile, mode)
            phase_profile("fit_m50", model50, args.profile, mode)
            phase_profile("fit_m200_pallas", model_p, args.profile, mode)
            phase_profile("fit_m50_pallas", model50_p, args.profile, mode)
            phase_profile("fit_m384", model384, args.profile, mode)
            phase_profile("fit_m384_pallas", model384_p, args.profile, mode)
            for name_, (_, _, mdl, _, _) in variational.items():
                if mdl is not model_mb_w:
                    phase_profile(name_, mdl, args.profile, mode)
            phase_profile("fit_mb100k", model_mb, args.profile, mode, minibatch_size=MB_B)
            with forced_gram():
                phase_profile("fit_mb100k_gram", model_mb_g, args.profile, mode,
                              minibatch_size=MB_B)
                phase_profile("fit_mb100k_gram_chunked", model_mb_gc, args.profile, mode,
                              minibatch_size=MB_B)
                phase_profile("fit_mb100k_gram_whitened", model_mb_w, args.profile, mode,
                              minibatch_size=MB_B)
            for name_, mdl, R, mb in (("multistart_m50", model_ms50, MS_M50["n_restarts"], None),
                                      ("multistart_m200", model_ms, MS_R, None),
                                      ("multistart_m200_pallas", model_ms_p, MS_R, None),
                                      ("multistart_mb100k", model_mb_g, MS_MB["adaptive_waves"],
                                       MB_B)):
                with forced_gram() if mdl is model_mb_g else contextlib.nullcontext():
                    phase_profile(name_, mdl, args.profile, mode,
                                  run=restart_runner(mdl, R, mode, minibatch_size=mb))
        phase_ab({"A": model, "B": model_p})

    def entry(kernel, launches, row, max_abs_err, shape):
        return {"name": kernel, "route": "cuda",
                "source": f"spatial_alignment_tpu_torch/csrc/{SOURCES[kernel]}.cu",
                "replaces": REPLACES[kernel], "launches": launches, "max_abs_err": max_abs_err,
                "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": shape}

    # Each kernel at the largest shape of its m = 200 path: the data layer's
    # solve (L (200, 200), B (200, 10)) and quad-diag (x (5, 4050, 200),
    # shared F (10, 200, 200), in the one-pass TF32 build the path's
    # "default" runs), the (14, 200, 200) factor slab; the Gram at the 100k
    # fit's data layer (x1 (100, 2), x2 (5, 8192, 2)). Launches are the
    # counts of the path's 200-step fit: fit_m200 for the Cholesky,
    # fit_m200_pallas for the next four, fit_mb100k_gram for the Gram.
    solve = next(r for r in new_record["trisolve"] if r["B"] == [200, 10] and not r["trans"])
    qf = max((r for r in prec_record["quad_fwd"] if r["x"][-1] == 200),
             key=lambda r: math.prod(r["x"]))
    qb = max((r for r in prec_record["quad_bwd"] if r["x"][-1] == 200),
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
              {"x": qf["x"], "F": qf["F"], "precision": "default"}),
        entry("quad_bwd", launches_p["quad_bwd"], qb, qb["max_abs_err"],
              {"x": qb["x"], "F": qb["F"], "precision": "default"}),
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
