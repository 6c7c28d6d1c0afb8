#!/usr/bin/env python3
"""What mapping the name ``high`` to a 3xTF32 split in cuBLAS would cost:
the width-C mean products (``svgp_matmul_precision``'s) on the card.

    python3 tools/mean_products.py

At the m = 200 data and warp layers and the 100k fit's data layer (A (S, N,
m) in the products' transposed layout, B (m, C)), each product three ways:
fp32 cuBLAS, one TF32 pass, and the operands split into TF32 high parts and
the rest, written as three cuBLAS TF32 GEMMs summed in float32. Prints one
JSON line with nvidia-smi's name and power limit, then one a shape: the
device time of each (``chip_smoke.median_ms``) and its error against
float64 (max-norm relative). Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mean_products: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import median_ms, nvidia_smi, rel_err
    from spatial_alignment_tpu_torch.ops import precision

    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()}),
          flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for S, N, m, C in ((5, 4050, 200, 10), (1, 4050, 200, 2), (5, 8192, 100, 10)):
        A = torch.randn((S, m, N), generator=gen, device="cuda").transpose(-1, -2)
        B = torch.randn((m, C), generator=gen, device="cuda")
        exact = A.double() @ B.double()

        def split3():
            hi = lambda t: (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
            ah, bh = hi(A), hi(B)
            with precision.tf32(True):
                return ah @ bh + (ah @ (B - bh) + (A - ah) @ bh)

        fp32 = lambda: precision.matmul(A, B, "highest")
        tf32 = lambda: precision.matmul(A, B, "default")
        print(json.dumps({"A": [S, N, m], "B": [m, C],
                          "fp32_ms": median_ms(fp32), "tf32_ms": median_ms(tf32),
                          "split_3xtf32_ms": median_ms(split3),
                          "fp32_rel": rel_err(fp32().double(), exact),
                          "tf32_rel": rel_err(tf32().double(), exact),
                          "split_3xtf32_rel": rel_err(split3().double(), exact)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
