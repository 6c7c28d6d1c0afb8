#!/usr/bin/env python3
"""Where a fresh process's first fit goes, on one NVIDIA GPU.

    python3 tools/fresh_fit.py [--epochs 300]

The command line (``python -m spatial_alignment_tpu_torch align``) runs one
fit in a new process, so its ``train_seconds`` holds every first-call cost
that a long-lived process pays once. This script is such a process: on
``chip_smoke.py``'s m = 200 model (fit_m200's data and flags) it times, each
ended by ``torch.cuda.synchronize()``, the CUDA context, the model's
construction, the training loop's stages in the first ``fit`` (the
optimizer's construction, which in a new process imports ``torch._dynamo``
for ``torch.optim``'s ``add_param_group``; ``TrainLoop._prime``: the
optimizer's state; ``_capture``: two eager warm-up steps and the capture),
each chunk of replays (``TrainLoop.run``,
100 steps and a copy of their losses to the host), the first fit as a
whole, and then a second fit of the same length on the cached graph. It
prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=300)
    args = parser.parse_args()
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("fresh_fit: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from spatial_alignment_tpu_torch import VariationalGPSA
    from spatial_alignment_tpu_torch.models import train
    from spatial_alignment_tpu_torch.ops import _build

    imports_s = time.perf_counter() - t_start
    row = {"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        "epochs": args.epochs, "imports_seconds": imports_s}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        row[key] = row.get(key, 0.0) + time.perf_counter() - t0
        return out

    timed("cuda_context_seconds", lambda: torch.zeros(1, device="cuda"))
    timed("kernel_build_seconds", _build.build_all)
    dd, _, _ = chip_smoke.two_view_data(45, 10)
    kw = dict(m_X_per_view=200, m_G=200, n_latent_gps={"expression": 10}, fixed_view_idx=0,
              mean_function="identity_fixed")
    model = timed("construct_seconds", lambda: VariationalGPSA(dd, **kw))
    prime, capture, run = train.TrainLoop._prime, train.TrainLoop._capture, train.TrainLoop.run
    train.TrainLoop._prime = lambda self: timed("loop_prime_seconds", lambda: prime(self))
    train.TrainLoop._capture = lambda self: timed("loop_warmup_and_capture_seconds",
                                                  lambda: capture(self))
    chunks = []

    def timed_run(self, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, *a)  # ends in a copy of the losses to the host
        chunks.append(time.perf_counter() - t0)
        return out

    train.TrainLoop.run = timed_run
    make_optimizer = VariationalGPSA._optimizer
    VariationalGPSA._optimizer = lambda self, *a, **k: timed(
        "optimizer_construct_seconds", lambda: make_optimizer(self, *a, **k))
    fit = lambda: model.fit(args.epochs, lr=1e-2, S=5, print_every=100, recipe="plain")
    timed("first_fit_seconds", fit)
    row["first_fit_chunk_seconds"], chunks[:] = list(chunks), []
    timed("second_fit_seconds", fit)
    row["second_fit_chunk_seconds"] = list(chunks)
    row["first_fit_steps_per_s"] = args.epochs / row["first_fit_seconds"]
    row["second_fit_steps_per_s"] = args.epochs / row["second_fit_seconds"]
    row["first_fit_rest_seconds"] = row["first_fit_seconds"] - sum(
        row[k] for k in ("optimizer_construct_seconds", "loop_prime_seconds",
                         "loop_warmup_and_capture_seconds")) - sum(row["first_fit_chunk_seconds"])
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
