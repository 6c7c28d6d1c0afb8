#!/usr/bin/env python3
"""How fast each variational parameterization aligns, for either package.

    python3 tools/variational_alignment.py --package torch              # the card, fit_m200's size
    JAX_PLATFORMS=cpu python3 tools/variational_alignment.py --package jax --grid 20 --m 100
    python3 tools/variational_alignment.py --package torch --device cpu --grid 20 --m 100

Builds ``chip_smoke.py``'s fit_m200 data and model (two views of grid^2
spots, m inducing points, 10 latent GPs, ``mixed`` solves; grid 45 and
m = 200 by default) once in each mode (square, triangular, whitened) from
the same seed, and fits each from its initial parameters for every step
count of ``--steps`` (one fit() call each, lr 1e-2, S = 5). Prints one JSON
line a mode and step count: the aligned error of the fitted coordinates,
the data's, and the warp posterior's mean variance at the inducing points
of the warped view, tr(S_u) / m with S_u the covariance q holds for the
inducing outputs (square A A^T, triangular L L^T, whitened
L_K A A^T L_K^T with L_K the warp Gram's jittered Cholesky), beside the
warp prior's (its Gram's mean diagonal).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MODES = {"square": {}, "triangular": {"triangular_variational": True},
         "whitened": {"whitened_variational": True}}


def warp_variances(params, consts, spec, kernel, eps):
    """(tr(S_u) / m, the prior's mean diagonal) of view 1's first warp
    channel, in float64 on the host."""
    f64 = lambda t: np.asarray(t, np.float64)
    A = f64(params["Omega_sqt_G"])[1, 0]
    m = A.shape[-1]
    if spec.triangular_variational or spec.whitened_variational:
        A = np.tril(A)
    hp = {**consts, **params}
    Xt = f64(hp["Xtilde"])[1]
    K = f64(kernel(Xt, Xt, f64(hp["warp_kernel_lengthscales"])[1],
                   f64(hp["warp_kernel_variances"])[1]))
    S_u = A @ A.T
    if spec.whitened_variational:
        LK = np.linalg.cholesky(K + eps * np.eye(m))
        S_u = LK @ S_u @ LK.T
    return float(np.trace(S_u) / m), float(np.trace(K) / m)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--device", default="cuda", help="torch only: cuda or cpu")
    ap.add_argument("--grid", type=int, default=45)
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--steps", default="50,100,200")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    rng_data = np.random.default_rng(0)
    kw = dict(kernel_lengthscale=5.0, kernel_variance=0.5, noise_variance=0.001)
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from spatial_alignment_tpu import VariationalGPSA
        from spatial_alignment_tpu.data.simulated import generate_twod_data
        from spatial_alignment_tpu.ops.kernels import get_kernel

        device, platform = {}, "cpu"
        to_np = lambda tree: jax.tree.map(np.asarray, tree)
    else:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            print("variational_alignment: no CUDA device (pass --device cpu)", file=sys.stderr)
            return 2
        from spatial_alignment_tpu_torch import VariationalGPSA
        from spatial_alignment_tpu_torch.data import generate_twod_data
        from spatial_alignment_tpu_torch.ops.kernels import get_kernel

        if args.device == "cpu":
            torch.set_num_threads(1)
        device = {"device": args.device}
        platform = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
        to_np = lambda tree: {k: ({kk: vv.detach().cpu().numpy() for kk, vv in v.items()}
                                  if isinstance(v, dict) else v.detach().cpu().numpy())
                              for k, v in tree.items()}
    X, Y, nsl, view_idx = generate_twod_data(
        2, 30, grid_size=args.grid, n_latent_gps=10, fixed_view_idx=0, rng=rng_data, **kw)
    dd = {"expression": {"spatial_coords": X.astype(np.float32),
                         "outputs": Y.astype(np.float32), "n_samples_list": nsl}}
    err = lambda G: float(np.mean(np.sum((G[view_idx[0]] - G[view_idx[1]]) ** 2, axis=1)))
    kernel = lambda a, b, ls, var: np.asarray(get_kernel("rbf")(a, b, ls, var))
    if args.package == "torch":
        import torch

        kernel = lambda a, b, ls, var: get_kernel("rbf")(
            *(torch.as_tensor(t) for t in (a, b, ls, var))).numpy()
    model_kw = dict(m_X_per_view=args.m, m_G=args.m, n_latent_gps={"expression": 10},
                    fixed_view_idx=0, mean_function="identity_fixed", **device)
    print(json.dumps({"platform": platform, "package": args.package, "grid": args.grid,
                      "m": args.m, "aligned_error_data": err(X)}), flush=True)
    for mode, flags in MODES.items():
        for steps in (int(s) for s in args.steps.split(",")):
            model = VariationalGPSA(dd, **model_kw, **flags)
            if steps == int(args.steps.split(",")[0]):
                v0 = warp_variances(to_np(model.params), to_np(model.consts), model.spec,
                                    kernel, model.spec.diagonal_offset)
                print(json.dumps({"mode": mode, "steps": 0,
                                  "aligned_error": err(model.predict({"expression": X})[0][
                                      "expression"]),
                                  "warp_var_q": v0[0], "warp_var_prior": v0[1]}), flush=True)
            losses = np.asarray(model.fit(n_epochs=steps, lr=1e-2, S=5))
            v = warp_variances(to_np(model.params), to_np(model.consts), model.spec, kernel,
                               model.spec.diagonal_offset)
            G = np.asarray(model.predict({"expression": X})[0]["expression"])
            print(json.dumps({"mode": mode, "steps": steps, "aligned_error": err(G),
                              "warp_var_q": v[0], "warp_var_prior": v[1],
                              "loss_last": float(losses[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
