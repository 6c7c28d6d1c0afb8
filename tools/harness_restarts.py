#!/usr/bin/env python3
"""Every restart of the m = 50 accuracy harness, for either package.

    python3 tools/harness_restarts.py --package torch [--modes template,denovo]   # the card
    JAX_PLATFORMS=cpu python3 tools/harness_restarts.py --package jax              # the CPU

Runs ``fit_multistart`` at the JAX package's shipped accuracy policy on
seed 0's draw of ``experiments/simulations/accuracy_robustness.py`` (two
views of 100 spots, m = 50, 5 latent GPs; 16 restarts of 10,000 epochs,
consistency selection, top-2 ensemble, mixed inits, accurate recipe) and
prints one JSON line a restart (its init family, consistency score, the
aligned error of its own coordinates, its last loss), then one with the
winner, the ensemble's aligned error and the seconds. With ``--single N``
it also fits N single models (seeds 0..N-1, the same recipe) and prints
their aligned errors: what one restart reaches without selection.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = ("random", "prealign", "ot")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--modes", default="denovo,template")
    ap.add_argument("--epochs", type=int, default=10_000)
    ap.add_argument("--restarts", type=int, default=16)
    ap.add_argument("--single", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from spatial_alignment_tpu import VariationalGPSA
        from spatial_alignment_tpu.data.simulated import generate_twod_data

        device = {}
        platform = "cpu"
    else:
        import torch

        if not torch.cuda.is_available():
            print("harness_restarts: the port's harness runs on the GPU", file=sys.stderr)
            return 2
        from spatial_alignment_tpu_torch import VariationalGPSA
        from spatial_alignment_tpu_torch.data import generate_twod_data

        device = {"device": "cuda"}
        platform = torch.cuda.get_device_name(0)
    X, Y, nsl, vi = generate_twod_data(
        2, 30, grid_size=10, n_latent_gps=5, kernel_lengthscale=5.0, kernel_variance=0.5,
        noise_variance=0.001, fixed_view_idx=0, rng=np.random.default_rng(0))
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    dd = {"expression": {"spatial_coords": X, "outputs": Y, "n_samples_list": nsl}}
    err = lambda c: float(np.mean(np.sum((c[vi[0]] - c[vi[1]]) ** 2, axis=1)))
    print(json.dumps({"package": args.package, "platform": platform,
                      "observed_error": err(X)}), flush=True)
    for mode in args.modes.split(","):
        kw = dict(m_X_per_view=50, m_G=50, n_latent_gps={"expression": 5},
                  mean_function="identity_fixed",
                  fixed_view_idx={"denovo": None, "template": 0}[mode], **device)
        model = VariationalGPSA(dd, seed=0, **kw)
        scores, orig = [], model._alignment_consistency

        def consistency(G, **k):
            s = orig(G, **k)
            scores.append((s, err(np.asarray(G["expression"]))))
            return s

        model._alignment_consistency = consistency
        t0 = time.perf_counter()
        model.fit_multistart(n_epochs=args.epochs, n_restarts=args.restarts, seed0=0, lr=1e-2,
                             S=5, select="consistency", ensemble_top_k=2, init="mixed",
                             recipe="accurate", verbose=False)
        seconds = time.perf_counter() - t0
        for r, (s, e) in enumerate(scores):
            print(json.dumps({"mode": mode, "restart": r, "init_family": FAMILIES[r % 3],
                              "consistency": s, "aligned_error": e}), flush=True)
        print(json.dumps({"mode": mode, "winner": model.multistart_winner_,
                          "aligned_error_ensemble": err(model.ensemble_G_means_["expression"]),
                          "seconds": seconds}), flush=True)
        for seed in range(args.single):
            single = VariationalGPSA(dd, seed=seed, **kw)
            single.fit(n_epochs=args.epochs, lr=1e-2, S=5, recipe="accurate")
            G = np.asarray(single.predict({"expression": X})[0]["expression"])
            print(json.dumps({"mode": mode, "single_seed": seed, "aligned_error": err(G)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
