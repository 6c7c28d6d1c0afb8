"""Command-line interface: align spatial datasets from files to artifacts.

The port's own copy of the JAX package's command line, with the same
subcommands, flags, defaults, artifacts and messages:

  python -m spatial_alignment_tpu_torch align --h5ad data.h5ad --out out/
  python -m spatial_alignment_tpu_torch align --coords a_xy.csv --counts a.csv \\
      --coords b_xy.csv --counts b.csv --template 0 --out out/
  python -m spatial_alignment_tpu_torch predict --checkpoint out/model.npz \\
      --at new_xy.csv --out preds/

`align` fits the model and writes aligned_coords.csv, losses.csv, a
self-contained model.npz checkpoint and summary.json; `predict` restores a
checkpoint and evaluates the deterministic posterior (aligned coordinates +
output moments) at new coordinates. Checkpoints are the JAX package's
format, so either package's `predict` reads either's `align` output.

Both run on the GPU. `--device cpu` runs them on the CPU; without a GPU and
without that flag they raise. `--h5ad` needs h5py; CSV input needs only
numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["main", "build_data_dict"]


def _load_views(args) -> tuple:
    """(X (N, D), Y (N, P), n_samples_list) from --h5ad or --coords/--counts."""
    if args.h5ad:
        from .data.realdata import load_h5ad

        d = load_h5ad(args.h5ad)
        if "spatial" not in d:
            raise SystemExit(f"{args.h5ad} has no obsm['spatial']")
        key = args.batch_key if args.batch_key.startswith("obs/") else f"obs/{args.batch_key}"
        if key not in d:
            raise SystemExit(
                f"{args.h5ad} has no {key}; columns: "
                f"{[k for k in d if k.startswith('obs/')]}"
            )
        batch = d[key]
        X = np.asarray(d["spatial"], np.float32)
        Y = np.asarray(d["X"], np.float32)
        order = []
        n_samples_list = []
        for b in sorted(set(batch.tolist())):
            idx = np.flatnonzero(batch == b)
            order.append(idx)
            n_samples_list.append(int(idx.size))
        order = np.concatenate(order)
        return X[order], Y[order], n_samples_list

    if not args.coords or len(args.coords) != len(args.counts):
        raise SystemExit("pass --h5ad, or matching --coords/--counts per view")
    from .data.realdata import load_csv_expression

    Xs, Ys = [], []
    for cpath, ypath in zip(args.coords, args.counts):
        x, y = load_csv_expression(cpath, ypath)
        Xs.append(x.astype(np.float32))
        Ys.append(y.astype(np.float32))
    P = {y.shape[1] for y in Ys}
    if len(P) != 1:
        raise SystemExit(f"views disagree on gene count: {sorted(P)}")
    return (
        np.concatenate(Xs),
        np.concatenate(Ys),
        [x.shape[0] for x in Xs],
    )


def build_data_dict(X, Y, n_samples_list, normalize: bool = False) -> Dict[str, dict]:
    if normalize:
        Y = np.log1p(Y)
        Y = (Y - Y.mean(0)) / np.maximum(Y.std(0), 1e-8)
    return {
        "expression": {
            "spatial_coords": np.asarray(X, np.float32),
            "outputs": np.asarray(Y, np.float32),
            "n_samples_list": list(n_samples_list),
        }
    }


def _build_model(args, data_dict):
    from .models.vgpsa import VariationalGPSA

    return VariationalGPSA(
        data_dict,
        m_X_per_view=args.m_x or args.m,
        m_G=args.m,
        n_latent_gps={"expression": args.n_latent_gps},
        mean_function=args.mean_function,
        kernel_func_warp=args.kernel,
        kernel_func_data=args.kernel,
        fixed_view_idx=args.template,
        seed=args.seed,
        triangular_variational=args.triangular,
        svgp_solve_mode=args.solve_mode,
        whitened_variational=args.whitened,
        analytic_data_likelihood=args.analytic,
        data_chunk_size=args.data_chunk_size,
        device=args.device,
    )


def _fit_kwargs(args):
    kw = {"recipe": args.recipe}
    if args.average_last:
        kw["average_last"] = args.average_last
    if getattr(args, "minibatch", None):
        kw["minibatch_size"] = args.minibatch
    return kw


def cmd_align(args) -> int:
    X, Y, n_samples_list = _load_views(args)
    data_dict = build_data_dict(X, Y, n_samples_list, normalize=args.normalize)
    model = _build_model(args, data_dict)
    view_idx, Ns, _, _ = model.create_view_idx_dict(data_dict)

    t0 = time.time()
    losses = model.fit(
        n_epochs=args.epochs, lr=args.lr, S=args.S,
        print_every=args.print_every, **_fit_kwargs(args),
    )
    train_s = time.time() - t0

    G_means, F_mean, _ = model.predict(
        {"expression": data_dict["expression"]["spatial_coords"]}, view_idx
    )
    aligned = np.asarray(G_means["expression"])

    os.makedirs(args.out, exist_ok=True)
    view_of = np.concatenate(
        [np.full(n, v, np.int64) for v, n in enumerate(n_samples_list)]
    )
    header = ",".join(
        ["view"]
        + [f"x{i}" for i in range(X.shape[1])]
        + [f"aligned_x{i}" for i in range(aligned.shape[1])]
    )
    np.savetxt(
        os.path.join(args.out, "aligned_coords.csv"),
        np.column_stack([view_of, data_dict["expression"]["spatial_coords"], aligned]),
        delimiter=",", header=header, comments="",
    )
    np.savetxt(
        os.path.join(args.out, "losses.csv"), losses, delimiter=",",
        header="neg_elbo", comments="",
    )
    # Self-contained: spec + data + optimizer state embedded, so `predict`
    # (and fit(resume_from=...)) need no model flags or data files.
    model.save(
        os.path.join(args.out, "model.npz"),
        step=args.epochs,
        extra={"normalize": bool(args.normalize), "seed": args.seed},
    )

    pre = post = None
    if len(n_samples_list) == 2 and n_samples_list[0] == n_samples_list[1]:
        v0, v1 = view_idx["expression"]
        pre = float(np.mean(np.sum((X[v0] - X[v1]) ** 2, -1)))
        post = float(np.mean(np.sum((aligned[v0] - aligned[v1]) ** 2, -1)))
    summary = {
        "n_views": len(n_samples_list),
        "n_samples_list": n_samples_list,
        "n_outputs": int(Y.shape[1]),
        "epochs": args.epochs,
        "final_neg_elbo": float(losses[-1]),
        "train_seconds": train_s,
        "pre_alignment_view_mse": pre,
        "post_alignment_view_mse": post,
        "artifacts": ["aligned_coords.csv", "losses.csv", "model.npz"],
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


def cmd_predict(args) -> int:
    from .models.vgpsa import VariationalGPSA

    try:
        # Self-contained checkpoint: spec + params + training data embedded,
        # so no model flags and no original data files are needed.
        model = VariationalGPSA.load(args.checkpoint, device=args.device)
    except ValueError:
        # A checkpoint of params/consts only (no spec): rebuild the model
        # from the data and the flags, then restore into it.
        X, Y, n_samples_list = _load_views(args)
        data_dict = build_data_dict(X, Y, n_samples_list, normalize=args.normalize)
        model = _build_model(args, data_dict)
        model.load(args.checkpoint)

    mod_name = model.spec.modality_names[0]
    n_views = model.spec.n_views
    D = model.spec.n_spatial_dims

    if args.at:
        import csv as _csv

        with open(args.at) as f:
            rows = list(_csv.reader(f))
        start = 1 if any(not _is_float(c) for c in rows[0]) else 0
        new_x = np.asarray(
            [[float(c) for c in r[:D]] for r in rows[start:]], np.float32
        )
        # align the same new points through every view's warp posterior
        vi = {
            mod_name: [
                np.arange(v * new_x.shape[0], (v + 1) * new_x.shape[0])
                for v in range(n_views)
            ]
        }
        coords = np.tile(new_x, (n_views, 1))
    elif args.h5ad or args.coords:
        X, _, n_samples_list = _load_views(args)
        if len(n_samples_list) != n_views:
            raise SystemExit(
                f"view-count mismatch: the checkpoint was trained with "
                f"{n_views} views but the input file has "
                f"{len(n_samples_list)} (n_samples_list={n_samples_list}); "
                "each input view is warped through its own trained "
                "posterior, so the counts must agree"
            )
        if X.shape[1] != D:
            raise SystemExit(
                f"spatial-dimension mismatch: checkpoint has {D}-D "
                f"coordinates, input file has {X.shape[1]}-D"
            )
        coords = np.asarray(X, np.float32)
        slices = np.insert(np.cumsum(n_samples_list), 0, 0)
        vi = {
            mod_name: [
                np.arange(slices[v], slices[v + 1]) for v in range(n_views)
            ]
        }
    else:
        # default: the training coordinates stored in the checkpoint
        if model._batch is None:
            raise SystemExit(
                "checkpoint has no embedded data (saved with "
                "include_data=False); pass --at or --h5ad/--coords"
            )
        from .models.spec import unpack_points

        coords = unpack_points(model.spec, mod_name, model._batch[mod_name]["coords"])
        vi = None

    G_means, F_mean, F_var = model.predict({mod_name: coords}, vi)
    os.makedirs(args.out, exist_ok=True)
    aligned = np.asarray(G_means[mod_name])
    mu = np.asarray(F_mean[mod_name])
    var = np.asarray(F_var[mod_name])
    np.savetxt(
        os.path.join(args.out, "aligned_coords.csv"), aligned, delimiter=",",
        header=",".join(f"aligned_x{i}" for i in range(aligned.shape[1])), comments="",
    )
    np.savetxt(os.path.join(args.out, "pred_mean.csv"), mu, delimiter=",")
    np.savetxt(os.path.join(args.out, "pred_var.csv"), var, delimiter=",")
    print(
        json.dumps(
            {
                "n_points": int(aligned.shape[0]),
                "n_outputs": int(mu.shape[1]),
                "artifacts": ["aligned_coords.csv", "pred_mean.csv", "pred_var.csv"],
            }
        )
    )
    return 0


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--h5ad", help="AnnData file with obsm['spatial'] + a batch column")
    ap.add_argument("--batch-key", default="batch", help="obs column naming the view")
    ap.add_argument("--coords", action="append", default=[],
                    help="per-view coordinates CSV (repeatable)")
    ap.add_argument("--counts", action="append", default=[],
                    help="per-view expression CSV (repeatable, paired with --coords)")
    ap.add_argument("--normalize", action="store_true",
                    help="log1p + per-gene standardization")
    ap.add_argument("--m", type=int, default=50, help="inducing points (m_G)")
    ap.add_argument("--m-x", type=int, default=None, help="m_X_per_view (default: --m)")
    ap.add_argument("--n-latent-gps", type=int, default=None,
                    help="LMC latent GPs (default: one per gene)")
    ap.add_argument("--kernel", default="rbf", choices=["rbf", "matern12", "matern32"])
    ap.add_argument("--mean-function", default="identity_fixed",
                    choices=["identity_fixed", "identity_initialized", "linear"])
    ap.add_argument("--template", type=int, default=None,
                    help="fixed view index (template-based alignment)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--triangular", action="store_true",
                    help="triangular variational factor (faster steps)")
    ap.add_argument("--whitened", action="store_true",
                    help="whitened variational parameterization (fastest "
                    "steps; posterior expressed relative to the prior)")
    ap.add_argument("--analytic", action="store_true",
                    help="closed-form data-layer expected log-likelihood")
    ap.add_argument("--solve-mode", default="auto",
                    choices=["auto", "solve", "kl_inverse", "inverse"],
                    help="how Kuu^-1 is applied (auto: kl_inverse at scale; "
                    "inverse = fastest, measured converged-accuracy cost)")
    ap.add_argument("--data-chunk-size", type=int, default=None)
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where to run (default: the GPU; without one the "
                    "command raises instead of running on the CPU)")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="spatial_alignment_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    ap = sub.add_parser("align", help="fit the model and write aligned coordinates")
    _add_common(ap)
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--S", type=int, default=5)
    ap.add_argument("--print-every", type=int, default=500)
    ap.add_argument("--recipe", choices=["plain", "accurate"], default="plain",
                    help="accurate = cosine lr decay + temperature-0 warp")
    ap.add_argument("--minibatch", type=int, default=None,
                    help="SVI minibatch size per view (unbiased subsampled "
                    "ELBO; per-step cost independent of spot count)")
    ap.add_argument("--average-last", type=int, default=None,
                    help="tail-average parameters over the last K epochs")
    ap.set_defaults(fn=cmd_align)

    ap = sub.add_parser("predict", help="restore a checkpoint and predict")
    _add_common(ap)
    ap.add_argument("--checkpoint", required=True, help="model.npz from align")
    ap.add_argument("--at", default=None,
                    help="CSV of new coordinates to align+predict at "
                    "(default: the training coordinates)")
    ap.set_defaults(fn=cmd_predict)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
