"""Entropic-OT coarse alignment baseline (PASTE-style, dependency-free).

A copy of the JAX package's ``utils/ot.py`` (numpy only), which the port
does not import. ``fit_multistart(init="ot")`` seeds restarts with
:func:`entropic_ot_align_views`.

Every reference alignment benchmark reports GPSA against the PASTE
optimal-transport baseline (the reference's experiments/simulations/
two_dimensional.py:25-26,65-82; simulation_large_numspots.py:71-91). The
PASTE package is not a dependency, but the comparison is
reproducible: PASTE's alignment step is (i) an OT coupling between the two
slices' spots driven by expression similarity, then (ii) a generalized
weighted Procrustes rigid transform computed from that coupling
(paste.visualization.stack_slices_pairwise). This module implements exactly
that recipe in plain numpy: log-domain Sinkhorn for the entropic OT
coupling over the expression cost, then coupling-weighted Kabsch.

It is a COARSE baseline by construction (rigid motions only — it cannot
undo nonlinear warps), which is the role it plays in the reference's
figures too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["sinkhorn", "ot_procrustes_align", "entropic_ot_align_views"]


def sinkhorn(
    C: np.ndarray,
    reg: float = 0.05,
    n_iters: int = 500,
    tol: float = 1e-9,
    a: Optional[np.ndarray] = None,
    b: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Entropic OT coupling for cost ``C`` (n, m) — log-domain Sinkhorn.

    Returns the coupling P (n, m) with marginals ``a`` (default uniform)
    and ``b``. ``reg`` is the entropic regularization relative to the cost
    scale (C is internally normalized by its mean, so reg is unitless).
    """
    n, m = C.shape
    a = np.full(n, 1.0 / n) if a is None else a / a.sum()
    b = np.full(m, 1.0 / m) if b is None else b / b.sum()
    K = -C / (reg * max(float(C.mean()), 1e-30))  # log-kernel
    log_a, log_b = np.log(a), np.log(b)
    f = np.zeros(n)
    g = np.zeros(m)
    for _ in range(n_iters):
        f_new = reg_logsumexp(K + g[None, :], axis=1)
        f = log_a - f_new
        g_new = reg_logsumexp(K + f[:, None], axis=0)
        g = log_b - g_new
        # marginal violation of the row constraint
        P_log = K + f[:, None] + g[None, :]
        err = np.abs(np.exp(reg_logsumexp(P_log, axis=1)) - a).max()
        if err < tol:
            break
    return np.exp(K + f[:, None] + g[None, :])


def reg_logsumexp(M: np.ndarray, axis: int) -> np.ndarray:
    mx = M.max(axis=axis, keepdims=True)
    out = np.log(np.exp(M - mx).sum(axis=axis)) + np.squeeze(mx, axis=axis)
    return out


def ot_procrustes_align(
    X1: np.ndarray,
    X2: np.ndarray,
    P: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rigid transform of X2 onto X1 from coupling P (weighted Kabsch).

    Minimizes sum_ij P_ij ||X1_i - (X2_j R + t)||^2 over rotations R and
    translations t (the PASTE stacking step). Returns (X2_aligned, R, t).
    """
    w1 = P.sum(axis=1)
    w2 = P.sum(axis=0)
    mu1 = (w1[:, None] * X1).sum(0) / w1.sum()
    mu2 = (w2[:, None] * X2).sum(0) / w2.sum()
    A = X1 - mu1
    B = X2 - mu2
    H = B.T @ P.T @ A  # (D, D)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    S = np.eye(H.shape[0])
    S[-1, -1] = d
    R = U @ S @ Vt
    t = mu1 - mu2 @ R
    return X2 @ R + t, R, t


def entropic_ot_align_views(
    X: np.ndarray,
    Y: np.ndarray,
    view_idx,
    reg: float = 0.05,
    n_iters: int = 500,
) -> np.ndarray:
    """PASTE-style coarse alignment of every view onto view 0.

    ``X`` (N, D) stacked coordinates, ``Y`` (N, P) stacked expression,
    ``view_idx`` list of per-view index arrays (reference layout). The OT
    cost between spots is the squared euclidean distance in expression
    space (PASTE's alpha->0 limit of fused GW: expression-driven coupling).
    Returns coordinates with views 1.. rigidly moved onto view 0's frame.
    """
    out = np.array(X, dtype=np.float64, copy=True)
    Y = np.asarray(Y, np.float64)
    i0 = np.asarray(view_idx[0])
    for v in range(1, len(view_idx)):
        iv = np.asarray(view_idx[v])
        C = (
            np.sum(Y[i0] ** 2, 1)[:, None]
            - 2.0 * Y[i0] @ Y[iv].T
            + np.sum(Y[iv] ** 2, 1)[None, :]
        )
        P = sinkhorn(C, reg=reg, n_iters=n_iters)
        out[iv], _, _ = ot_procrustes_align(out[i0], out[iv], P)
    return out
