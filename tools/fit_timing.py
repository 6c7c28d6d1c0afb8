#!/usr/bin/env python3
"""Time the m = 200 fit of this checkout's port against an earlier
checkout's, in turns on one GPU, beside this checkout's eager step under
each Adam.

    python3 tools/fit_timing.py --parent DIR [--steps N] [--rounds R] [--out FILE]

DIR is an earlier checkout, e.g. unpacked with
``git archive <rev> | tar -x -C DIR``. Each turn is a process of its own
(parent, this, this, parent, per round) that imports the port from its
checkout, builds chip_smoke.py's fit_m200 model (``two_view_data(45, 10)``:
N = 4,050, m = 200, 10-latent LMC) and times ``fit(n_epochs=N)`` after a
warm fit of 10 steps (where fit() captures its step, the warm fit does the
capture). This checkout's turns also time N eager steps of
``make_train_step`` under the capturable Adam (fit()'s default on the card)
and under the non-capturable one, each after 5 warm steps. Every time ends
with ``torch.cuda.synchronize()`` and is given in ms a step. One JSON object,
with nvidia-smi's name and power limit, goes to stdout and to FILE (default
spatial_alignment_tpu_torch/_build/fit_timing.json). Needs a CUDA device
and nvcc; exits 2 without a device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def turn(root: Path, steps: int) -> dict:
    """One turn in this process: the times of the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from spatial_alignment_tpu_torch import VariationalGPSA

    dd, _, _ = smoke.two_view_data(45, 10)
    model = VariationalGPSA(dd, m_X_per_view=200, m_G=200, n_latent_gps={"expression": 10},
                            fixed_view_idx=0, mean_function="identity_fixed", device="cuda")

    def ms_per_step(run) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    model.fit(n_epochs=10, lr=1e-2, S=5)
    out = {"fit_ms": ms_per_step(lambda: model.fit(n_epochs=steps, lr=1e-2, S=5))}
    if hasattr(model, "make_train_step"):
        adams = {"eager_capturable_ms": None,
                 "eager_noncapturable_ms": lambda p: torch.optim.Adam(p, lr=1e-2)}
        for name, factory in adams.items():
            step, _ = model.make_train_step(lr=1e-2, S=5, optimizer=factory)
            for _ in range(5):
                step()
            out[name] = ms_per_step(lambda: [step() for _ in range(steps)])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="the earlier checkout")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--out", type=Path,
                        default=ROOT / "spatial_alignment_tpu_torch" / "_build" / "fit_timing.json")
    parser.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fit_timing: no CUDA device", file=sys.stderr)
        return 2
    if args.turn is not None:
        print(json.dumps(turn(args.turn, args.steps)))
        return 0
    if args.parent is None:
        parser.error("--parent is required")
    roots = {"parent": args.parent.resolve(), "this": ROOT}
    order = [tag for _ in range(args.rounds) for tag in ("parent", "this", "this", "parent")]
    times = {tag: {} for tag in roots}
    for tag in order:
        cmd = [sys.executable, __file__, "--turn", str(roots[tag]), "--steps", str(args.steps)]
        done = subprocess.run(cmd, capture_output=True, text=True, check=True)
        for key, value in json.loads(done.stdout.strip().splitlines()[-1]).items():
            times[tag].setdefault(key, []).append(value)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"device": smi, "steps": args.steps, "order": order, **times}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
