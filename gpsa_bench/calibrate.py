"""Readings of the comparison that decides ``correct``, for setting a
cell's limits (``limits/<cell>.json``): the program's on many seeds, the
control's and each planted fault's on a few.

    python3 gpsa_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--lowered-seeds 1,2,3] [--fault-seeds 1,2,3] \\
        [--float32-seeds 1,2] [--constructor-start] [--numbers loss,grad,...] \\
        [--from LOG ...]

on the card, from the root of a checkout. Each seed builds the cell's
model and runs set-up's first calls, as a run does (no window), and prints
one JSON line of readings, with the leaves that read most. The kinds:

``program``   the program as the cell runs it;
``control``   the program on its own path one precision below the
              configuration's: the configuration's ``control`` model
              options, and with ``"allow_tf32"`` PyTorch's TF32 switches on
              for every float32 product the options leave alone;
``lowered``   the reference one precision below, in the program's place;
``float32``, ``float32_differences``  the reference in plain float32, with
              the model's expansion of the squared distances and without
              it: witnesses of what float32 itself resolves;
each fault of ``reference.FAULTS``, planted in the reference put in the
program's place.

The last lines sum up: per number, the largest reading of the program and
the smallest of each other kind; with ``--numbers``, the limits those
readings give (:func:`limits`). ``--from`` reads the readings from the
output of earlier runs instead: this script's, and run.py's standard error
(a sound run's compared numbers). ``--constructor-start`` keeps the
constructor's starting parameters in place of the configuration's
``init``.
"""

import argparse
import copy
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path.insert(0, str(ROOT))

WITNESSES = ("lowered", "float32", "float32_differences")


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def _worst(prog, ref, n=3):
    """The ``n`` leaves that read most, of the gradient and of the change."""
    from gpsa_bench import harness

    return {k: sorted(v.items(), key=lambda kv: -kv[1])[:n]
            for k, v in harness.leaf_gaps(prog, ref).items()}


class _tf32:
    """PyTorch's TF32 switches set to ``on`` inside, put back after."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        if self.on:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def calibrate(resolved: dict, program_seeds, other_seeds: dict, device: str = "cuda",
              emit=print) -> dict:
    """{kind: [readings]} for kind "program", "control", each witness and
    each fault; "<kind> crashed": the seeds on which that kind raised."""
    import torch

    from gpsa_bench import harness, reference

    cfg, traffic = resolved["config"], resolved["traffic"]
    control = cfg.get("control") or {}
    control_traffic = copy.deepcopy(traffic)
    control_traffic["model_options"] = {**(traffic.get("model_options") or {}),
                                        **control.get("model_options", {})}
    dev = torch.device(device)
    out = {}

    def program(tr, seed):
        model, data, init, prog = harness.setup(cfg, tr, seed, dev)
        harness.program_outputs(model, data, cfg, prog)
        del model
        harness.free(dev)
        return data, init, prog

    todo = sorted(set(program_seeds) | {s for v in other_seeds.values() for s in v})
    for seed in todo:
        t0 = time.perf_counter()
        data, init, prog = program(traffic, seed)
        ref = harness.follow_reference(init, data, cfg, traffic, seed, reference.Precision())
        kinds = {}
        if seed in program_seeds:
            kinds["program"] = prog
        for kind, kind_seeds in other_seeds.items():
            if seed not in kind_seeds:
                continue
            try:
                if kind == "control":
                    with _tf32(bool(control.get("allow_tf32"))):
                        kinds[kind] = program(control_traffic, seed)[-1]
                    continue
                precision = (reference.Precision("control" if kind == "lowered" else kind)
                             if kind in WITNESSES else reference.Precision("reference", fault=kind))
                kinds[kind] = harness.follow_reference(init, data, cfg, traffic, seed,
                                                       precision)
            except RuntimeError as e:
                # A control that crashes has failed and gives no reading.
                out.setdefault(f"{kind} crashed", []).append(seed)
                emit(json.dumps({"seed": seed, "kind": kind, "crashed": str(e)[:300]}))
                harness.free(dev)
        for kind, got in kinds.items():
            r = harness.readings(got, ref, data)
            out.setdefault(kind, []).append(r)
            emit(json.dumps({"seed": seed, "kind": kind, **r, "worst": _worst(got, ref),
                             "seconds": time.perf_counter() - t0}))
    return out


def summary(out: dict) -> dict:
    """Per kind and number: the program's largest reading, the others'
    smallest finite one (a reading that is not a number has failed and
    sets no upper end); a kind that crashed lists its seeds."""
    s = {}
    for kind, rows in out.items():
        if not rows or not isinstance(rows[0], dict):
            s[kind] = rows
            continue
        keys = {k for r in rows for k in r}
        if kind == "program":
            s[kind] = {k: max(r[k] for r in rows if k in r) for k in keys}
        else:
            s[kind] = {k: min((r[k] for r in rows if k in r and math.isfinite(r[k])),
                              default=math.inf) for k in keys}
    return s


# Numbers that measure the parameters' change: a step that hands its state
# back unchanged reads 1 on them without a run.
CHANGE_NUMBERS = ("change", "change_median")
# The kind one precision below the configuration's; the others are faults
# (the witnesses set no limit).
LOWER_PRECISION = ("control",)


def limits(s: dict, numbers) -> dict:
    """Limits of ``numbers`` from a summary: the lower reading is the
    program's largest; the upper the smallest of a lower precision's
    reading where it is 3 times the lower or more, of each fault's where
    it is 10 times or more, and of 1 (an unchanged state) for the change
    numbers; the limit lies 60 % of the way from lower to upper on a log
    scale. A number with no upper reading gets none and is left out."""
    out = {}
    for k in numbers:
        lower = s["program"][k]
        uppers = [1.0] if k in CHANGE_NUMBERS else []
        for kind, rows in s.items():
            if kind == "program" or kind in WITNESSES or not isinstance(rows, dict):
                continue
            factor = 3.0 if kind in LOWER_PRECISION else 10.0
            if rows[k] >= factor * lower:
                uppers.append(rows[k])
        if uppers:
            upper = min(uppers)
            out[k] = float(f"{lower ** 0.4 * upper ** 0.6:.2g}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--from", dest="logs", nargs="*", default=[],
                    help="read the readings from the output of earlier runs instead of running")
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--lowered-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--float32-seeds", type=seeds, default=[],
                    help="the reference in plain float32, with and without the expansion")
    ap.add_argument("--constructor-start", action="store_true",
                    help="keep the constructor's starting parameters")
    ap.add_argument("--numbers", default="",
                    help="comma-separated numbers to set limits for from these readings")
    args = ap.parse_args(argv)

    from gpsa_bench import harness, reference

    others = {"control": args.control_seeds, "lowered": args.lowered_seeds,
              "float32": args.float32_seeds, "float32_differences": args.float32_seeds}
    others.update({f: args.fault_seeds for f in reference.FAULTS})
    resolved = harness.resolve(args.workload)
    if args.constructor_start:
        resolved["config"]["init"] = None
    if args.logs:
        out = {}
        for log in args.logs:
            text = Path(log).read_text().splitlines()
            # A run's standard error: its compared numbers, one program reading.
            checks = [line.split() for line in text if line.startswith("check ")]
            if checks:
                out.setdefault("program", []).append({c[1]: float(c[2]) for c in checks})
            for line in text:
                if line.startswith('{"seed"'):
                    row = json.loads(line)
                    if "crashed" in row:
                        out.setdefault(f"{row['kind']} crashed", []).append(row["seed"])
                    else:
                        out.setdefault(row["kind"], []).append(
                            {k: v for k, v in row.items()
                             if k not in ("seed", "kind", "seconds", "worst")})
    else:
        out = calibrate(resolved, args.seeds, others)
    s = summary(out)
    print(json.dumps({"summary": s}), flush=True)
    if args.numbers:
        print(json.dumps({"limits": limits(s, args.numbers.split(","))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
