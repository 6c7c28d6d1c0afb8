"""Run one cell of the benchmark of the PyTorch / CUDA port of GPSA.

    python3 gpsa_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Builds the cell's inputs and model from the
seed, warms up (set-up), repeats the cell's entry call for ``--seconds``,
then compares the first steps with the plain reference and prints one JSON
line, the last on standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics and a breakdown. Exits 2
without a CUDA device, 3 without the port's package, 4 when modules of JAX
or the JAX package were loaded; then it prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every cache the program or PyTorch may write stays at a fixed path inside
# the checkout (the port builds its kernels into its own _build/).
for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gpsa_bench import harness

    cell = harness.resolve(args.workload)
    if not (ROOT / "spatial_alignment_tpu_torch" / "__init__.py").exists():
        print("the port's package spatial_alignment_tpu_torch is not in this checkout",
              file=sys.stderr)
        return 3
    chips = int(cell["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
