"""Shared reading of the span metrics: one run of ``spanrun.py`` (a traced
replica of the run, with the program's spans on from its start, in a
process of its own) per traced run, its numbers kept for every reader.

A stop-gap, to go when ``harness.py`` turns the spans on in the run's own
process and its profiled call splits its own idle (``PERF.md`` §7): then
the readers read ``ctx`` and this module, its subprocess and its cache go.

The replica makes its inputs from ``SEED``, not from the run's ``--seed``:
a reader is handed ``ctx`` alone, which holds no seed, and the layers'
times it reads do not depend on the draw. Where the program has no span
recorder (``utils.profiling.enable_spans``), every span metric reads
nothing; where it has one and the replica fails, the reader raises, so the
traced run fails with it."""

import json
import subprocess
import sys

from gpsa_bench.byname import BENCH_DIR

# The seed of the replica's inputs and model.
SEED = 1
_cache = {}


def _has_spans() -> bool:
    from spatial_alignment_tpu_torch.utils import profiling

    return hasattr(profiling, "enable_spans")


def result(ctx) -> dict:
    """The replica's numbers for the run's configuration and traffic
    ({"setup", "call", "step"}, ``spanrun.replica``), or {} where the
    program has no span recorder."""
    request = json.dumps({"config": ctx["config"], "traffic": ctx["traffic"], "seed": SEED},
                         sort_keys=True)
    if request not in _cache:
        _cache[request] = _run(request) if _has_spans() else {}
    return _cache[request]


def _run(request: str) -> dict:
    proc = subprocess.run([sys.executable, str(BENCH_DIR / "spanrun.py")], input=request,
                          capture_output=True, text=True, timeout=1800,
                          cwd=str(BENCH_DIR.parent))
    for line in proc.stderr.splitlines()[-40:]:
        print(f"spanrun: {line}", file=sys.stderr, flush=True)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"the span replica (spanrun.py) failed: exit {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def step_ms(ctx, part: str):
    """Device ms of one step's operations that ``gpsa.<part>`` launched
    (forward and backward), or None where the step ran none."""
    row = result(ctx).get("step", {}).get(f"gpsa.{part}")
    return row[0] if row and row[1] else None
