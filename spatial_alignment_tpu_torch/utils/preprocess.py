"""Count-data preprocessing and small spatial utilities (host-side numpy).

The port's copy of ``spatial_alignment_tpu/utils/preprocess.py`` (the port
imports nothing of the JAX package): the reference's preprocessing helpers
(``gpsa/util/util.py``) for size factors with unit geometric mean,
Poisson/NB deviance machinery, analytic Pearson residuals, the "AxB"
ST-index parser, and the pinwheel toy dataset. They run once on ingest, on
the host. For the same inputs they return the JAX package's arrays
(``tests/test_torch_utils.py``).
"""

from __future__ import annotations

import warnings

import numpy as np
import numpy.random as npr
from scipy.special import xlogy

__all__ = [
    "polar_warp",
    "get_st_coordinates",
    "compute_distance",
    "make_pinwheel",
    "compute_size_factors",
    "poisson_deviance",
    "deviance_feature_selection",
    "deviance_residuals",
    "pearson_residuals",
]


def _as_array(m):
    """Accept pandas objects or ndarrays; return a float ndarray view."""
    return np.asarray(m.values if hasattr(m, "values") else m, dtype=float)


def polar_warp(X, r, theta):
    """Displace each 2-D point by radius ``r`` at angle ``theta``."""
    offsets = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1)
    return np.asarray(X) + offsets


def get_st_coordinates(df):
    """Spatial coordinates from an ST index of ``"AxB"`` strings.

    Each index entry like ``"12.5x7"`` parses to the float pair (12.5, 7.0).
    """
    return np.array([[float(tok) for tok in spot.split("x")] for spot in df.index])


def compute_distance(X1, X2):
    """Mean Euclidean distance between corresponding rows."""
    return float(np.mean(np.linalg.norm(np.asarray(X1) - np.asarray(X2), axis=1)))


def make_pinwheel(radial_std, tangential_std, num_classes, num_per_class, rate, rs=None):
    """Pinwheel toy dataset: Gaussian arms swirled by a rate-scaled rotation.

    Semantics match the classic autograd demo used by the reference: features
    are anisotropic Gaussian draws shifted to radius ~1 on the x-axis, each
    point rotated by its class angle plus ``rate * exp(radial coordinate)``.
    """
    if rs is None:
        rs = npr.RandomState(0)
    n = num_classes * num_per_class
    features = rs.randn(n, 2) * np.array([radial_std, tangential_std])
    features[:, 0] += 1.0
    class_angles = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)
    angles = np.repeat(class_angles, num_per_class) + rate * np.exp(features[:, 0])
    # Row-vector rotation: (x, y) @ [[c, -s], [s, c]].
    c, s = np.cos(angles), np.sin(angles)
    x, y = features[:, 0], features[:, 1]
    return np.stack([x * c + y * s, y * c - x * s], axis=1)


def compute_size_factors(m):
    """Per-sample Poisson size factors, normalized to unit geometric mean.

    ``m`` holds samples in columns (DataFrame or ndarray).
    """
    col_sums = _as_array(m).sum(axis=0)
    geo_mean = np.exp(np.mean(np.log(col_sums)))
    return col_sums / geo_mean


def poisson_deviance(X, sz):
    """Per-feature Poisson deviance vs the constant-rate null model.

    ``X`` holds features in rows and samples in columns; ``sz`` are the
    per-sample size factors. Zero counts contribute zero to the saturated
    log-likelihood (``xlogy`` convention).
    """
    counts = _as_array(X)
    sz = np.asarray(sz, dtype=float)
    ll_saturated = xlogy(counts, counts / sz).sum(axis=1)
    feature_totals = counts.sum(axis=1)
    ll_null = xlogy(feature_totals, feature_totals / sz.sum())
    return 2.0 * (ll_saturated - ll_null)


def deviance_feature_selection(X):
    """Rank features (rows of DataFrame ``X``) by Poisson deviance.

    Features with zero total count are dropped. Returns
    ``(deviances, feature_names)`` aligned with each other.
    """
    X = X[np.sum(X, axis=1) > 0]
    deviances = np.asarray(poisson_deviance(X, compute_size_factors(X)))
    names = X.index.values
    if names.shape[0] != deviances.shape[0]:
        raise AssertionError("feature/deviance length mismatch")
    return deviances, names


def _clamped_sqrt(sq):
    """sqrt with negative inputs (fp round-off) clamped to zero, with a note."""
    neg = sq < 0
    if np.any(neg):
        n_neg = int(neg.sum())
        warnings.warn(
            f"clamping {n_neg} negative sqrt arguments to 0 "
            f"({100.0 * n_neg / sq.size:.4f}% of entries)",
            RuntimeWarning,
            stacklevel=3,
        )
        sq = np.where(neg, 0.0, sq)
    return np.sqrt(sq)


def deviance_residuals(x, theta, mu=None):
    """Deviance residuals under an NB (finite ``theta``) or Poisson model.

    When ``mu`` is omitted it defaults to the rank-1 margins estimate
    (row totals x column totals / grand total).
    """
    x = np.asarray(x, dtype=float)
    if mu is None:
        mu = x.sum(axis=1, keepdims=True) * x.sum(axis=0, keepdims=True) / x.sum()
    if np.isinf(theta):  # Poisson limit
        sq = 2.0 * (xlogy(x, x / mu) - (x - mu))
    else:  # negative binomial
        xt = x + theta
        sq = 2.0 * (xlogy(x, x / mu) - xt * np.log(xt / (mu + theta)))
    return np.sign(x - mu) * _clamped_sqrt(sq)


def pearson_residuals(counts, theta, clipping=True):
    """Analytic Pearson residuals for the NB model.

    Uses the rank-1 margins estimate of the mean; when ``clipping`` is on,
    residuals are clipped to ±sqrt(n_samples).
    """
    counts = np.asarray(counts, dtype=float)
    mu = (
        counts.sum(axis=1, keepdims=True)
        * counts.sum(axis=0, keepdims=True)
        / counts.sum()
    )
    z = (counts - mu) / np.sqrt(mu + mu**2 / theta)
    if clipping:
        bound = np.sqrt(counts.shape[0])
        z = np.clip(z, -bound, bound)
    return z
