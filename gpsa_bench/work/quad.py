"""Quadratic-form diagonals y[g, l, i] = sum_k (x[g, i] @ F[l or (g, l)])_k^2
for x (G, N, m) and F (L, m, m) or (G, L, m, m), as the port's ``quad_diag``
takes them (leading dims of x folded into G).

Forward: the product x F, 2 G L N m^2 operations, and the squares and sums,
2 G L N m; x and F read, y (G, L, N) written.
Backward, from dy (G, L, N): the product t = x F again (the forward keeps no
(G, L, N, m) intermediate), dx = sum_l (2 dy t) F^T and dF = x^T (2 dy t),
three products; x, F and dy read, dx and dF written."""

from __future__ import annotations

import math

from . import F32, unique_numel


def _dims(x, F):
    G = math.prod(x.shape[:-2])
    N, m = x.shape[-2:]
    L = F.shape[-3]
    return G, N, m, L


def forward(x, F, precision="highest") -> dict:
    G, N, m, L = _dims(x, F)
    flops = 2 * G * L * N * m * m + 2 * G * L * N * m
    return {"flops": flops, "bytes": F32 * (unique_numel(x) + unique_numel(F) + G * L * N)}


def backward(x, F, precision="highest") -> dict:
    G, N, m, L = _dims(x, F)
    flops = 3 * 2 * G * L * N * m * m + 3 * G * L * N * m
    return {"flops": flops,
            "bytes": F32 * (2 * unique_numel(x) + 2 * unique_numel(F) + G * L * N)}


def rate(precision: str) -> str:
    """The peak a product at ``precision`` may run at: one TF32 pass under
    ``default``, float32 otherwise."""
    return "tf32" if precision == "default" else "fp32"
