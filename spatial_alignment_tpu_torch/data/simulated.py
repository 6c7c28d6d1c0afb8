"""Synthetic two-dimensional datasets (numpy, host side).

The port's own copy of ``generate_twod_data`` from
``spatial_alignment_tpu/data/simulated.py``: GP-sampled outputs on a grid,
optionally mixed through a ground-truth LMC, then GP-warped per view. For the
same ``rng`` it returns identical arrays.
"""

from __future__ import annotations

import numpy as np

from ..ops.kernels import rbf_kernel_numpy
from .warps import _mvn_sample, apply_gp_warp

__all__ = ["generate_twod_data"]

_OUTPUT_KERNEL_PARAMS = np.array([np.log(1.0), np.log(1.0)])


def _sample_outputs(X, n_outputs, n_latent_gps, rng, jitter=1e-3):
    """GP-sampled output columns, optionally through a ground-truth LMC."""
    K = rbf_kernel_numpy(X, X, _OUTPUT_KERNEL_PARAMS) + jitter * np.eye(X.shape[0])
    nY = n_outputs if n_latent_gps is None else n_latent_gps
    Y = np.stack([_mvn_sample(np.zeros(X.shape[0]), K, rng) for _ in range(nY)], axis=1)
    if n_latent_gps is not None:
        W = rng.normal(size=(n_latent_gps, n_outputs))
        Y = Y @ W
    return Y


def generate_twod_data(
    n_views,
    n_outputs,
    grid_size,
    n_latent_gps=None,
    kernel_variance=0.1,
    kernel_lengthscale=5,
    noise_variance=0.0,
    fixed_view_idx=None,
    rng=None,
):
    """grid_size^2 spots per view on [0,10]^2, GP-sampled outputs (optionally
    LMC), GP warp per view; ``fixed_view_idx`` leaves one view unwarped.

    Returns (X, Y, n_samples_list, view_idx).
    """
    rng = rng or np.random.default_rng()
    ax = np.linspace(0, 10, grid_size)
    X1, X2 = np.meshgrid(ax, ax)
    X_orig_single = np.vstack([X1.ravel(), X2.ravel()]).T

    Y_orig = _sample_outputs(X_orig_single, n_outputs, n_latent_gps, rng)

    X, Y, n_samples_list, view_idx = apply_gp_warp(
        X_orig_single,
        Y_orig,
        n_views=n_views,
        kernel_variance=kernel_variance,
        kernel_lengthscale=kernel_lengthscale,
        noise_variance=noise_variance,
        rng=rng,
    )
    if fixed_view_idx is not None:
        X[view_idx[fixed_view_idx]] = X_orig_single
    return X, Y, n_samples_list, view_idx
