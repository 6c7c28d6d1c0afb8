"""Automatic coarse affine pre-alignment (numpy).

A copy of the JAX package's ``utils/prealign.py``: the port imports nothing
of that package, not even its numpy-only modules. ``fit_multistart(init=
"prealign")`` seeds restarts with :func:`moment_align`.

The reference's real-data experiments hand-tune a rotation before fitting
GPSA (slideseq_prediction.py:110-136 "manual coarse rotation",
macosko two_slice_alignment.py:28-80 "rotate slice 2 by 90 degrees") because
the warp GP's identity-mean prior only models local deformation. This module
automates that step: each view is affinely mapped so its expression-weighted
spatial moments match the template view's.

Method (no point correspondences needed): for each of a set of feature
weights w_g(spot) = softplus-normalized expression of gene g, compute the
weighted centroid and weighted covariance of the view's coordinates. The
rigid/affine map aligning view moments to template moments is recovered by
(a) matching total covariance via the symmetric square-root transform and
(b) resolving the remaining rotation ambiguity by a 1-D search over rotations
(and optional reflection) scoring the match of all per-gene centroids.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["coarse_affine_prealign", "moment_align"]


def _feature_weights(Y: np.ndarray) -> np.ndarray:
    """Nonnegative per-gene spot weights, each column summing to 1."""
    W = Y - Y.min(axis=0, keepdims=True)
    col = W.sum(axis=0, keepdims=True)
    col[col == 0] = 1.0
    return W / col


def _weighted_centroids(X: np.ndarray, W: np.ndarray) -> np.ndarray:
    """(G, D) expression-weighted centroids, one per gene."""
    return W.T @ X


def _total_moments(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = X.mean(axis=0)
    C = np.cov((X - mu).T) + 1e-9 * np.eye(X.shape[1])
    return mu, C


def _sqrtm_spd(C: np.ndarray) -> np.ndarray:
    w, V = np.linalg.eigh(C)
    return (V * np.sqrt(np.maximum(w, 1e-12))) @ V.T


def moment_align(
    X_view: np.ndarray,
    Y_view: np.ndarray,
    X_tmpl: np.ndarray,
    Y_tmpl: np.ndarray,
    n_angles: int = 360,
    allow_reflection: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Affine (A, b) mapping view coords toward the template frame.

    Covariance whitening/recoloring fixes scale and shear; the rotation left
    undetermined by second moments is found by matching per-gene
    expression-weighted centroids.
    """
    D = X_view.shape[1]
    mu_v, C_v = _total_moments(X_view)
    mu_t, C_t = _total_moments(X_tmpl)
    T_recolor = _sqrtm_spd(C_t)
    T_whiten = np.linalg.inv(_sqrtm_spd(C_v))

    Wv = _feature_weights(Y_view)
    Wt = _feature_weights(Y_tmpl)
    cent_t = _weighted_centroids(X_tmpl, Wt) - mu_t  # (G, D), template frame
    Xw = (X_view - mu_v) @ T_whiten.T  # whitened view coords

    if D != 2:
        # >2-D: skip the rotation search (second moments only)
        A = T_recolor @ T_whiten
        b = mu_t - mu_v @ A.T
        return A.T, b

    best = (np.inf, None)
    reflections = [np.eye(2)] + (
        [np.diag([1.0, -1.0])] if allow_reflection else []
    )
    for refl in reflections:
        for theta in np.linspace(0, 2 * np.pi, n_angles, endpoint=False):
            R = np.array(
                [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
            ) @ refl
            A = T_recolor @ R @ T_whiten
            cent_v = _weighted_centroids((X_view - mu_v) @ A.T, Wv)
            score = float(np.mean(np.sum((cent_v - cent_t) ** 2, axis=1)))
            if score < best[0]:
                best = (score, A)
    A = best[1]
    b = mu_t - mu_v @ A.T
    return A.T, b


def coarse_affine_prealign(
    coords_list: List[np.ndarray],
    counts_list: List[np.ndarray],
    template_idx: int = 0,
    allow_reflection: bool = False,
) -> List[np.ndarray]:
    """Map every view's coordinates into the template view's frame by
    expression-moment matching. Returns the transformed coordinate list
    (template unchanged). Feed the result to VariationalGPSA, whose warp GP
    then only has to resolve the residual nonlinear deformation."""
    out = []
    Xt, Yt = coords_list[template_idx], counts_list[template_idx]
    for i, (X, Y) in enumerate(zip(coords_list, counts_list)):
        if i == template_idx:
            out.append(np.asarray(X, float).copy())
            continue
        A_T, b = moment_align(
            np.asarray(X, float), np.asarray(Y, float),
            np.asarray(Xt, float), np.asarray(Yt, float),
            allow_reflection=allow_reflection,
        )
        out.append(np.asarray(X, float) @ A_T + b)
    return out
