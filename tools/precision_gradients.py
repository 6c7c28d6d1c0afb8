#!/usr/bin/env python3
"""How far the precision names move fit_m200's first loss and gradients, on
each route, beside float32's own distance from float64 (on the card).

    python3 tools/precision_gradients.py [--lengthscales init 0.3 1.0 ...]

Builds ``chip_smoke.py``'s m = 200 model (two views of a 45 x 45 grid, 10
latent GPs; the names resolve to ``high``/``default``), its opt-in twin, and
a third model with the opt-ins but the quad-diag's plain version (cuBLAS at
the same names), which tells the one-pass quad kernel from one TF32 pass
itself. At the constructor's parameters (``init``) or with every warp and
data lengthscale set to the given value, from one set of injected draws,
it runs ``chip_smoke.precision_first_rows`` without its limits and prints
one JSON line a route and case: the loss of each name and of float64 on the
CPU, and each leaf's gradient error (max-norm relative) of default against
highest, of highest against float64 (float32's floor) and of default
against float64. The float64 computation is made once a case and shared
by the routes, which compute one function.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lengthscales", nargs="+", default=["init"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("precision_gradients: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from spatial_alignment_tpu_torch import VariationalGPSA

    cases = tuple(c if c == "init" else float(c) for c in args.lengthscales)
    dd, _, _ = cs.two_view_data(45, 10)
    kw = dict(m_X_per_view=200, m_G=200, n_latent_gps={"expression": 10}, fixed_view_idx=0,
              mean_function="identity_fixed", device="cuda")
    plain_quad = {k: v for k, v in cs.OPT_INS.items() if k != "quad_diag_impl"}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi()}),
          flush=True)
    reference = None
    for route, extra in (("fit_m200", {}), ("fit_m200_pallas", cs.OPT_INS),
                         ("fit_m200_pallas_plain_quad", plain_quad)):
        model = VariationalGPSA(dd, **kw, **extra)
        rows, reference = cs.precision_first_rows(route, model, reference, cases, hold=False)
        for case, row in rows.items():
            for k in ("grad_rel", "highest_vs_float64", "default_vs_float64"):
                row[k + "_max"] = max(row[k].values())
            print(json.dumps({"route": route, "lengthscales": case, **row}), flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
