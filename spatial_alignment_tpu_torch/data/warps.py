"""Ground-truth warp fields for simulations (numpy, host side).

The port's own copy of ``spatial_alignment_tpu/data/warps.py``: per-view
GP-drawn warps, a multimodal variant sharing one warp across modalities,
uniform-random affine warps and polar warps. Same arithmetic, same rng draw
order: for the same ``rng`` each returns the JAX package's arrays.
"""

from __future__ import annotations

import numpy as np

from ..ops.kernels import rbf_kernel_numpy

__all__ = [
    "apply_gp_warp",
    "apply_gp_warp_multimodal",
    "apply_linear_warp",
    "apply_polar_warp",
]


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


def apply_gp_warp_multimodal(
    X_orig_singles,
    Y_orig_singles,
    n_views,
    noise_variance=0.0,
    kernel_variance=1.0,
    kernel_lengthscale=1.0,
    mean_slope=1.0,
    mean_intercept=0.0,
    rng=None,
):
    """One GP warp shared across modalities per view, the joint coordinates
    rescaled to [0, 10]. Returns per-modality lists (X, Y, n_samples_list)
    and the views' row offsets."""
    assert len(X_orig_singles) == len(Y_orig_singles)
    rng = rng or np.random.default_rng()
    n_modalities = len(X_orig_singles)

    modality_idx = np.insert(np.cumsum([x.shape[0] for x in X_orig_singles]), 0, 0)
    X_joint = np.concatenate(X_orig_singles, axis=0).astype(float)
    X_joint = X_joint - X_joint.min(0)
    X_joint = X_joint / X_joint.max(0)
    X_joint *= 10.0

    n_per_view = X_joint.shape[0]
    n_spatial_dims = X_joint.shape[1]
    warp_kernel_params = np.array([np.log(kernel_variance), np.log(kernel_lengthscale)])
    K = rbf_kernel_numpy(X_joint, X_joint, warp_kernel_params)

    X = np.concatenate([X_joint.copy()] * n_views, axis=0)
    for vv in range(n_views):
        idx = np.arange(n_per_view * vv, n_per_view * (vv + 1))
        for ss in range(n_spatial_dims):
            X[idx, ss] = _mvn_sample(X_joint[:, ss] * mean_slope + mean_intercept, K, rng)

    view_offsets = np.array([n_per_view * vv for vv in range(n_views)])
    X_warped, Y_warped, n_samples_list = [], [], []
    for mm in range(n_modalities):
        rows = np.concatenate(
            [off + np.arange(modality_idx[mm], modality_idx[mm + 1]) for off in view_offsets]
        )
        X_warped.append(X[rows])
        Y_full = np.concatenate([Y_orig_singles[mm]] * n_views, axis=0)
        Y_full = Y_full + rng.normal(scale=np.sqrt(noise_variance), size=Y_full.shape)
        Y_warped.append(Y_full)
        n_samples_list.append([X_orig_singles[mm].shape[0]] * n_views)
    return X_warped, Y_warped, n_samples_list, view_offsets


def apply_linear_warp(
    X_orig_single,
    Y_orig_single,
    n_views,
    linear_slope_variance=0.1,
    linear_intercept_variance=0.1,
    noise_variance=0.01,
    rng=None,
):
    """Uniform-random per-dimension affine warp of every view."""
    rng = rng or np.random.default_rng()
    n_samples_per_view, n_spatial_dims = X_orig_single.shape
    n_samples_list = [n_samples_per_view] * n_views
    view_idx = _view_idx_array(n_samples_list)

    X = np.concatenate([X_orig_single.copy()] * n_views, axis=0)
    for vv in range(n_views):
        slopes = rng.uniform(1 - linear_slope_variance, 1 + linear_slope_variance, n_spatial_dims)
        # As in the reference, whose intercepts are a uniform draw with
        # equal bounds: a constant, and no draw from rng.
        intercepts = np.full(n_spatial_dims, linear_intercept_variance)
        X[n_samples_per_view * vv : n_samples_per_view * (vv + 1)] = (
            X_orig_single * slopes + intercepts
        )

    Y = np.concatenate([Y_orig_single] * n_views, axis=0)
    Y = Y + rng.normal(scale=np.sqrt(noise_variance), size=Y.shape)
    return X, Y, n_samples_list, view_idx


def apply_polar_warp(
    X_orig_single,
    Y_orig_single,
    n_views,
    linear_slope_variance=0.1,
    linear_intercept_variance=0.1,
    noise_variance=0.01,
    rng=None,
):
    """Radial warp x + r (cos t, sin t) of every view, with (r, t) = X B and
    B uniform on [-linear_slope_variance, linear_slope_variance]."""
    rng = rng or np.random.default_rng()
    n_samples_per_view, n_spatial_dims = X_orig_single.shape
    n_samples_list = [n_samples_per_view] * n_views
    view_idx = _view_idx_array(n_samples_list)

    X = np.concatenate([X_orig_single.copy()] * n_views, axis=0)
    for vv in range(n_views):
        B = rng.uniform(
            -linear_slope_variance, linear_slope_variance, (n_spatial_dims, n_spatial_dims)
        )
        polar_params = X_orig_single @ B
        r, theta = polar_params[:, 0], polar_params[:, 1]
        warped = np.array(
            [
                X_orig_single[:, 0] + r * np.cos(theta),
                X_orig_single[:, 1] + r * np.sin(theta),
            ]
        ).T
        X[n_samples_per_view * vv : n_samples_per_view * (vv + 1)] = warped

    Y = np.concatenate([Y_orig_single] * n_views, axis=0)
    Y = Y + rng.normal(scale=np.sqrt(noise_variance), size=Y.shape)
    return X, Y, n_samples_list, view_idx
