#!/usr/bin/env python3
"""Where the time of the Cholesky kernel's panel design goes, panel by
panel, on one GPU.

    python3 tools/panel_trace.py [--shapes 14x384,4x512] [--out FILE]

Builds an instrumented copy of ``csrc/cholesky.cu`` (with the flags of
``spatial_alignment_tpu_torch/ops/_build.py``) into
``spatial_alignment_tpu_torch/_build/trace/``: in the first block, lane 0
of every warp records ``clock64()`` before each block barrier of
``panel_cholesky`` (common.cuh), warp 0 also after the look-ahead signal
and after factoring the diagonal block, warps 1..7 after the look-ahead;
with a cluster (m >= 384) the first block is the first cluster's first.
The sources in ``csrc/`` are not changed. For each shape (batch x m,
m > 240) it launches the kernel on random SPD input once to warm up and
once traced, and prints one JSON object: per panel, in SM cycles, the
solve of the rows below (b: from the previous barrier to the last warp's
arrival), the look-ahead (the next diagonal block's elements), warp 0's
factorization of that block, the tiles (the last of warps 1..7), and the
whole step (c); beside the SM clock nvidia-smi reads just after. Needs a
CUDA device and nvcc; exits 2 without a device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MAX_PANELS = 64
TRACE_DEFS = f"""
__device__ unsigned long long g_trace[{MAX_PANELS} * 32 + 1];
#define TRACE_START ({MAX_PANELS} * 32)
#define TRACE(p, e) do {{ if (blockIdx.x == 0 && threadIdx.x % 32 == 0 && (p) < {MAX_PANELS}) \\
  g_trace[(p) * 32 + (e) * 8 + threadIdx.x / 32] = clock64(); }} while (0)
"""
# (text in panel_cholesky, text to put in its place)
EDITS = [
    ("  team.sync();  // L11 of the first panel is in dblk; every block has started\n",
     "  team.sync();  // L11 of the first panel is in dblk; every block has started\n"
     "  if (blockIdx.x == 0 && tid == 0) g_trace[TRACE_START] = clock64();\n"),
    ("    team.sync();  // (b) L21 is in P, in every block\n",
     "    TRACE(j0 / NB, 0);\n    team.sync();  // (b) L21 is in P, in every block\n"),
    ("      factor_block<kInverse>(dblk, kLdd, diag + j1, db, failed, lane);\n",
     "      TRACE(j0 / NB, 1);\n"
     "      factor_block<kInverse>(dblk, kLdd, diag + j1, db, failed, lane);\n"
     "      TRACE(j0 / NB, 2);\n"),
    ("      for (int t = nd + team.rank * (kCholThreads - 32) + tid - 32;",
     "      TRACE(j0 / NB, 1);\n"
     "      for (int t = nd + team.rank * (kCholThreads - 32) + tid - 32;"),
    ("    team.sync();  // (c) the trailing matrix is updated, the next L11 stored\n",
     "    TRACE(j0 / NB, 3);\n"
     "    team.sync();  // (c) the trailing matrix is updated, the next L11 stored\n"),
]
READER = """
extern "C" int sat_trace_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
"""


def instrumented(out_dir: Path) -> Path:
    """Write the traced cholesky.cu and common.cuh into out_dir; return the .cu."""
    csrc = ROOT / "spatial_alignment_tpu_torch" / "csrc"
    common = (csrc / "common.cuh").read_text()
    start = common.index("__device__ bool panel_cholesky(")
    end = common.index("\n}\n", start)
    body = common[start:end]
    for old, new in EDITS:
        if body.count(old) != 1:
            raise RuntimeError(f"panel_cholesky no longer holds {old!r} once")
        body = body.replace(old, new)
    anchor = "namespace {\n"
    common = common[:start] + body + common[end:]
    common = common.replace(anchor, anchor + TRACE_DEFS, 1)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "common.cuh").write_text(common)
    src = out_dir / "cholesky.cu"
    src.write_text((csrc / "cholesky.cu").read_text() + READER)
    return src


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shapes", default="2x256,14x384,4x512",
                        help="comma-separated BATCHxM, m > 240")
    parser.add_argument("--out", type=Path, help="also write the JSON object here")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("panel_trace: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi, spd
    from spatial_alignment_tpu_torch.ops import _build

    out_dir = ROOT / "spatial_alignment_tpu_torch" / "_build" / "trace"
    src = instrumented(out_dir)
    lib_path = out_dir / "libcholesky_trace.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.sat_cholesky_f32.argtypes = [vp, vp, vp, ll, i, vp]
    lib.sat_cholesky_scratch_floats.argtypes = [ll, i]
    lib.sat_cholesky_scratch_floats.restype = ll
    lib.sat_trace_read.argtypes = [vp]

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    record = {"device": nvidia_smi(), "shapes": []}
    for spec in args.shapes.split(","):
        B, m = (int(v) for v in spec.split("x"))
        A = spd(gen, B, m, "cuda")
        out = torch.empty_like(A)
        scratch = torch.empty(max(1, lib.sat_cholesky_scratch_floats(B, m)), device="cuda")
        for _ in range(2):  # warm, then traced
            err = lib.sat_cholesky_f32(A.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, m,
                                       torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
        buf = (ctypes.c_ulonglong * (MAX_PANELS * 32 + 1))()
        if lib.sat_trace_read(buf):
            raise RuntimeError("could not read the trace")
        t = list(buf)
        at = lambda p, e, w: t[p * 32 + e * 8 + w]
        prev = t[MAX_PANELS * 32]
        panels = []
        for p in range((m - 1) // 32):
            b_end = max(at(p, 0, w) for w in range(8))
            c_end = max(at(p, 3, w) for w in range(8))
            panels.append({
                "b": b_end - prev,
                "lookahead": max(at(p, 1, w) for w in range(1, 8)) - b_end,
                "warp0_wait": at(p, 1, 0) - b_end,
                "factor": at(p, 2, 0) - at(p, 1, 0),
                "warp0_done": at(p, 3, 0) - b_end,
                "tiles_done": max(at(p, 3, w) for w in range(1, 8)) - b_end,
                "c": c_end - b_end,
            })
            prev = c_end
        total = prev - t[MAX_PANELS * 32]
        sums = {k: sum(p[k] for p in panels) for k in panels[0]}
        record["shapes"].append({"shape": [B, m, m], "sm_clock": clock, "cycles_total": total,
                                 "cycles_sum": sums, "panels": panels})
    text = json.dumps(record)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
