"""Ground-truth GP warps for simulations (numpy, host side).

The port's own copy of the parts of ``spatial_alignment_tpu/data/warps.py``
that :mod:`.simulated` needs; same arithmetic, same rng draw order.
"""

from __future__ import annotations

import numpy as np

from ..ops.kernels import rbf_kernel_numpy

__all__ = ["apply_gp_warp"]


def _view_idx_array(n_samples_list):
    cs = np.insert(np.cumsum(n_samples_list), 0, 0)
    return np.array([np.arange(cs[i], cs[i + 1]) for i in range(len(n_samples_list))])


def _mvn_sample(mean, cov, rng):
    """Draw one MVN sample via Cholesky with escalating jitter."""
    n = cov.shape[0]
    jitter = 1e-10
    for _ in range(8):
        try:
            L = np.linalg.cholesky(cov + jitter * np.eye(n))
            return mean + L @ rng.standard_normal(n)
        except np.linalg.LinAlgError:
            jitter *= 10
    raise np.linalg.LinAlgError("covariance not PSD even with jitter")


def apply_gp_warp(
    X_orig_single,
    Y_orig_single,
    n_views,
    noise_variance=0.0,
    kernel_variance=1.0,
    kernel_lengthscale=1.0,
    mean_slope=1.0,
    mean_intercept=0.0,
    rng=None,
):
    """Per-view, per-dimension GP-drawn warp: each view's coordinates are an
    independent MVN draw with mean slope*x + intercept and RBF covariance
    over the original coordinates."""
    rng = rng or np.random.default_rng()
    n_samples_per_view, n_spatial_dims = X_orig_single.shape
    warp_kernel_params = np.array([np.log(kernel_variance), np.log(kernel_lengthscale)])
    K = rbf_kernel_numpy(X_orig_single, X_orig_single, warp_kernel_params)

    n_samples_list = [n_samples_per_view] * n_views
    view_idx = _view_idx_array(n_samples_list)

    X = np.concatenate([X_orig_single.copy()] * n_views, axis=0)
    for vv in range(n_views):
        for ss in range(n_spatial_dims):
            warped = _mvn_sample(X_orig_single[:, ss] * mean_slope + mean_intercept, K, rng)
            X[n_samples_per_view * vv : n_samples_per_view * (vv + 1), ss] = warped

    Y = np.concatenate([Y_orig_single] * n_views, axis=0)
    Y = Y + rng.normal(scale=np.sqrt(noise_variance), size=Y.shape)
    return X, Y, n_samples_list, view_idx
