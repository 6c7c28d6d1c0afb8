"""Evaluation metrics used by the reference's real-data experiments.

The port's copy of ``spatial_alignment_tpu/utils/metrics.py`` (host-side
numpy; the port imports nothing of the JAX package):

- Moran's I spatial autocorrelation, which the reference computes through
  squidpy (its Visium Moran's I experiment) to show that alignment raises
  per-gene spatial coherence: a kNN weight matrix and the standard Moran
  statistic, without the squidpy stack.
- Landmark distances: hand-placed anatomical landmark pairs compared across
  aligned views (the reference's Slide-seq landmark experiment).
"""

from __future__ import annotations

import numpy as np

__all__ = ["morans_i", "morans_i_test", "landmark_distances"]


def _knn_weights(coords: np.ndarray, n_neighbors: int) -> "np.ndarray":
    """Binary kNN adjacency, ``n_neighbors`` ones a row (dense, small-N
    evaluation use).

    Each point's neighbours are the ``n_neighbors + 1`` nearest from
    ``scipy.spatial.cKDTree`` less the first, the point itself; the JAX
    package asks sklearn's ``NearestNeighbors`` for the same. Where two
    candidates lie at the same distance, the two libraries may keep
    different ones, and the weights then differ.
    """
    from scipy.spatial import cKDTree

    _, idx = cKDTree(coords).query(coords, k=n_neighbors + 1)
    n = coords.shape[0]
    W = np.zeros((n, n))
    rows = np.repeat(np.arange(n), n_neighbors)
    W[rows, idx[:, 1:].ravel()] = 1.0
    return W


def _morans_i_from_weights(W: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Moran's I per column of ``values`` for a precomputed weight matrix."""
    values = np.asarray(values, dtype=float)
    if values.ndim == 1:
        values = values[:, None]
    n = W.shape[0]
    z = values - values.mean(axis=0, keepdims=True)
    num = np.einsum("if,ij,jf->f", z, W, z)
    den = np.sum(z**2, axis=0)
    den = np.where(den == 0, 1.0, den)
    return (n / W.sum()) * num / den


def morans_i(coords: np.ndarray, values: np.ndarray, n_neighbors: int = 6) -> np.ndarray:
    """Moran's I per column of ``values`` over kNN weights on ``coords``.

    I = (N / W_sum) * (z^T W z) / (z^T z), z = value - mean.
    Returns an array of shape (n_features,) (scalar input -> shape (1,)).
    """
    coords = np.asarray(coords, dtype=float)
    return _morans_i_from_weights(_knn_weights(coords, n_neighbors), values)


def morans_i_test(
    coords: np.ndarray, values: np.ndarray, n_neighbors: int = 6
) -> dict:
    """Moran's I with analytic one-sided significance under normality.

    Mirrors what the reference gets from ``squidpy.gr.spatial_autocorr``
    (visium_morans_i.py:73-143, moransi_post_alignment.py:88-113): per
    feature, the statistic I, a normal-approximation p-value for positive
    autocorrelation, and BH-FDR adjusted p-values. Returns
    ``{"I": (F,), "pval_norm": (F,), "pval_norm_fdr_bh": (F,)}``.
    """
    from scipy.stats import norm

    values = np.asarray(values, dtype=float)
    if values.ndim == 1:
        values = values[:, None]
    coords = np.asarray(coords, dtype=float)
    n = coords.shape[0]
    W = _knn_weights(coords, n_neighbors)
    I = _morans_i_from_weights(W, values)

    # Moments of I under the normality assumption (Cliff & Ord).
    s0 = W.sum()
    s1 = 0.5 * np.sum((W + W.T) ** 2)
    s2 = np.sum((W.sum(axis=1) + W.sum(axis=0)) ** 2)
    e_i = -1.0 / (n - 1)
    var_i = (n**2 * s1 - n * s2 + 3 * s0**2) / ((n**2 - 1) * s0**2) - e_i**2
    z = (I - e_i) / np.sqrt(max(var_i, 1e-30))
    pval = norm.sf(z)  # one-sided: positive spatial autocorrelation

    from .gsea import bh_fdr

    return {"I": I, "pval_norm": pval, "pval_norm_fdr_bh": bh_fdr(pval)}


def landmark_distances(
    aligned_coords_a: np.ndarray, aligned_coords_b: np.ndarray
) -> np.ndarray:
    """Per-landmark Euclidean distance between matched points of two views
    after alignment (compute_landmark_distances.py:36-50)."""
    a = np.asarray(aligned_coords_a, dtype=float)
    b = np.asarray(aligned_coords_b, dtype=float)
    if a.shape != b.shape:
        raise ValueError(f"landmark sets differ in shape: {a.shape} vs {b.shape}")
    return np.sqrt(np.sum((a - b) ** 2, axis=1))
