"""The GPSA two-dimensional simulation, frozen
(``spatial_alignment_tpu_torch/data/simulated.py:generate_twod_data``):
``grid_size``^2 spots a view on a grid over [0, 10]^2, outputs drawn from a
GP of unit lengthscale and variance through a ground-truth LMC of
``n_latent`` latents, each view's coordinates a GP draw around the grid
(RBF, ``warp_lengthscale``, ``warp_variance``), Gaussian noise of
``noise_variance``; the fixed view keeps the grid. The mathematics is the
original's; one factorization serves every draw of one covariance, which
the original repeats per draw."""

from __future__ import annotations

import math

import torch

SPATIAL_DIMS = 2


def points_per_view(data: dict) -> list:
    return [int(data["grid_size"]) ** 2] * int(data["n_views"])


def _rbf(x, z, lengthscale, variance):
    d2 = torch.cdist(x / lengthscale, z / lengthscale).square()
    return variance * torch.exp(-0.5 * d2)


def _mvn_factor(cov):
    """Lower Cholesky of ``cov`` with the original's escalating jitter
    (1e-10, times 10 up to eight times)."""
    n = cov.shape[0]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    jitter = 1e-10
    for _ in range(8):
        L, info = torch.linalg.cholesky_ex(cov + jitter * eye)
        if int(info) == 0:
            return L
        jitter *= 10
    raise RuntimeError("covariance not PSD even with jitter")


def make(data: dict, gen, device):
    g, V = int(data["grid_size"]), int(data["n_views"])
    P, L = int(data["n_outputs"]), int(data["n_latent"])
    f64 = torch.float64
    ax = torch.linspace(0, 10, g, dtype=f64, device=device)
    x1, x2 = torch.meshgrid(ax, ax, indexing="xy")
    grid = torch.stack([x1.reshape(-1), x2.reshape(-1)], dim=1)  # (n, 2)
    n = grid.shape[0]
    eye = torch.eye(n, dtype=f64, device=device)
    # Outputs: L latent GP draws (lengthscale 1, variance 1, jitter 1e-3) mixed by W.
    K = _rbf(grid, grid, 1.0, 1.0) + 1e-3 * eye
    Lk = _mvn_factor(K)
    Z = torch.randn((n, L), generator=gen, dtype=f64, device=device)
    W = torch.randn((L, P), generator=gen, dtype=f64, device=device)
    Y1 = (Lk @ Z) @ W
    Y = Y1.repeat(V, 1)
    Y = Y + math.sqrt(float(data["noise_variance"])) * torch.randn(
        Y.shape, generator=gen, dtype=f64, device=device)
    # Warp: every view and dimension a GP draw around the grid.
    Kw = _rbf(grid, grid, float(data["warp_lengthscale"]), float(data["warp_variance"]))
    Lw = _mvn_factor(Kw)
    Zw = torch.randn((n, V * 2), generator=gen, dtype=f64, device=device)
    warped = (Lw @ Zw).reshape(n, V, 2).permute(1, 0, 2) + grid[None]
    fixed = data.get("fixed_view_idx")
    if fixed is not None:
        warped[int(fixed)] = grid
    X = warped.reshape(V * n, 2)
    return X.float(), Y.float(), [n] * V
