"""Fused Cholesky and inverse of (..., m, m) matrices: L (m^3 / 3
operations) and L^-1 (m^3 / 3); the matrices read, L and L^-1 written
whole."""

from __future__ import annotations

from . import F32, batch, unique_numel


def forward(a) -> dict:
    m, b = a.shape[-1], batch(a)
    return {"flops": b * 2 * m**3 / 3, "bytes": F32 * (unique_numel(a) + 2 * b * m * m)}
