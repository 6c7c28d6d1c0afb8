"""Batched Cholesky factorization A = L L^T of (..., m, m) matrices:
m^3 / 3 operations a matrix; the matrices read and the factors written
whole (the kernel writes L's zero upper triangle)."""

from __future__ import annotations

from . import F32, batch, unique_numel


def forward(a) -> dict:
    m = a.shape[-1]
    return {"flops": batch(a) * m**3 / 3, "bytes": F32 * (unique_numel(a) + batch(a) * m * m)}
