"""Triangular solves with a lower factor L (..., m, m): X = L^-1 B (or
L^-T B) for B (..., m, n), m^2 n operations a matrix, L's triangle and B
read, X written; and the explicit inverse L^-1, m^3 / 3 operations, the
triangle read and written. A factor broadcast over the batch is read once."""

from __future__ import annotations

from . import F32, batch, unique_numel


def _triangle(L) -> float:
    m = L.shape[-1]
    return unique_numel(L) / (m * m) * m * (m + 1) / 2


def forward(L, B=None, trans=False) -> dict:
    m = L.shape[-1]
    if B is None:  # the inverse
        b = batch(L)
        return {"flops": b * m**3 / 3, "bytes": F32 * (_triangle(L) + b * m * (m + 1) / 2)}
    n = B.shape[-1]
    b = max(batch(L), batch(B))
    return {"flops": b * m * m * n,
            "bytes": F32 * (_triangle(L) + unique_numel(B) + b * m * n)}
