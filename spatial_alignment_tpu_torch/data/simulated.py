"""Synthetic one- and two-dimensional datasets (numpy, host side).

The port's own copy of ``spatial_alignment_tpu/data/simulated.py``:
GP-sampled outputs over grid or uniform coordinates, optionally mixed
through a ground-truth LMC, then warped per view. For the same ``rng`` each
generator returns the JAX package's arrays.
"""

from __future__ import annotations

import numpy as np

from ..ops.kernels import rbf_kernel_numpy
from .warps import _mvn_sample, _view_idx_array, apply_gp_warp

__all__ = [
    "generate_oned_data_affine_warp",
    "generate_oned_data_gp_warp",
    "generate_twod_data",
    "generate_twod_data_partial_overlap",
]

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



def generate_oned_data_affine_warp(
    n_views,
    n_outputs,
    n_samples_per_view,
    noise_variance=0.0,
    n_latent_gps=None,
    scale_factor=1.1,
    additive_factor=0.3,
    rng=None,
):
    """1-D data on uniform coordinates; every view after the first is
    warped by x * scale_factor + additive_factor. ``n_latent_gps`` is
    honoured (the reference hard-codes 2 inside).

    Returns (X, Y, n_samples_list, view_idx).
    """
    rng = rng or np.random.default_rng()
    X_orig_single = rng.uniform(-10, 10, size=(n_samples_per_view, 1))
    n_samples_list = [n_samples_per_view] * n_views
    view_idx = _view_idx_array(n_samples_list)

    Y_orig = _sample_outputs(X_orig_single, n_outputs, n_latent_gps, rng, jitter=0.0)
    Y = np.concatenate([Y_orig] * n_views, axis=0)
    Y = Y + rng.normal(scale=np.sqrt(noise_variance), size=Y.shape)
    X = np.concatenate([X_orig_single.copy()] * n_views, axis=0)
    X[n_samples_per_view:] = X[n_samples_per_view:] * scale_factor + additive_factor
    return X, Y, n_samples_list, view_idx


def generate_oned_data_gp_warp(
    n_views,
    n_outputs,
    n_samples_per_view,
    noise_variance=0.0,
    n_latent_gps=None,
    kernel_variance=1.0,
    kernel_lengthscale=1.0,
    mean_slope=1.0,
    mean_intercept=0.0,
    rng=None,
):
    """1-D data on a linspace grid over [-10, 10] with a GP warp per view.
    With an LMC and two outputs the mixing is W = [[1, -1]], as in the
    reference.

    Returns (X, Y, n_samples_list, view_idx).
    """
    rng = rng or np.random.default_rng()
    X_orig_single = np.linspace(-10, 10, n_samples_per_view).reshape(-1, 1)
    n_samples_list = [n_samples_per_view] * n_views
    view_idx = _view_idx_array(n_samples_list)

    K = rbf_kernel_numpy(X_orig_single, X_orig_single, _OUTPUT_KERNEL_PARAMS)
    nY = n_outputs if n_latent_gps is None else n_latent_gps
    Y_orig = np.stack(
        [_mvn_sample(np.zeros(n_samples_per_view), K, rng) for _ in range(nY)], axis=1
    )
    if n_latent_gps is not None:
        if n_outputs == 2:
            W = np.expand_dims(np.array([1, -1]), 0)
        else:
            W = rng.normal(size=(n_latent_gps, n_outputs))
        Y_orig = Y_orig @ W

    Y = np.concatenate([Y_orig] * n_views, axis=0)
    Y = Y + rng.normal(scale=np.sqrt(noise_variance), size=Y.shape)

    Kw = rbf_kernel_numpy(
        X_orig_single,
        X_orig_single,
        np.array([np.log(kernel_variance), np.log(kernel_lengthscale)]),
    )
    X = np.concatenate([X_orig_single.copy()] * n_views, axis=0)
    for vv in range(n_views):
        warped = _mvn_sample(X_orig_single[:, 0] * mean_slope + mean_intercept, Kw, rng)
        X[n_samples_per_view * vv : n_samples_per_view * (vv + 1), 0] = warped
    return X, Y, n_samples_list, view_idx


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


def generate_twod_data_partial_overlap(
    n_views,
    n_outputs,
    grid_size,
    n_latent_gps=None,
    kernel_variance=0.1,
    kernel_lengthscale=5,
    noise_variance=0.0,
    rng=None,
):
    """Two views of a grid on [-5, 5]^2, GP-warped, where the second keeps
    only the centre square |x|, |y| < 2.5 (a field-of-view mismatch).
    ``n_views`` is accepted as in the reference; there are always two.

    Returns (X, Y, n_samples_list, view_idx, keep_idx).
    """
    rng = rng or np.random.default_rng()
    ax = np.linspace(-5, 5, grid_size)
    X1, X2 = np.meshgrid(ax, ax)
    X_orig_single = np.vstack([X1.ravel(), X2.ravel()]).T
    keep_idx = np.logical_and(
        np.abs(X_orig_single[:, 0]) < 2.5, np.abs(X_orig_single[:, 1]) < 2.5
    )

    Y_orig = _sample_outputs(X_orig_single, n_outputs, n_latent_gps, rng)

    X, Y, n_samples_list, view_idx = apply_gp_warp(
        X_orig_single,
        Y_orig,
        n_views=2,
        kernel_variance=kernel_variance,
        kernel_lengthscale=kernel_lengthscale,
        noise_variance=noise_variance,
        rng=rng,
    )
    n = grid_size**2
    X = np.concatenate([X[:n], X[n:][keep_idx]])
    Y = np.concatenate([Y[:n], Y[n:][keep_idx]])
    view_idx = [np.arange(n), n + np.arange(int(keep_idx.sum()))]
    n_samples_list = [n, int(keep_idx.sum())]
    return X, Y, n_samples_list, view_idx, keep_idx
