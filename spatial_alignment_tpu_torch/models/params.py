"""Parameter construction and initialization (PyTorch port).

Counterpart of ``spatial_alignment_tpu/models/params.py``. The learned
state is two plain nested dicts of float32 tensors:

  params  trainable leaves
  consts  frozen hyperparameters (fixed kernel params, identity warp means)

Every leaf is drawn host-side from ``np.random.default_rng(seed)`` in the
same order as the JAX package, so for the same seed the leaves are
bit-identical. The one exception is the k-means inducing-point init: the
JAX package calls sklearn, which the port does not depend on, so
:func:`kmeans_centers` is seeded numpy of its own with the JAX package's
two branches: k-means++ plus Lloyd (sklearn's ``KMeans``) up to 20,000
points, mini-batch k-means (sklearn's ``MiniBatchKMeans``) above. Its
centres differ from sklearn's; its inertia is of the same quality.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .spec import ModelSpec, _as_numpy, view_slices

__all__ = ["kmeans_centers", "init_inducing", "init_params", "merge_hyperparams"]


def _sq_dists(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    d = (x * x).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * x @ c.T
    return np.maximum(d, 0.0)


def _kmeanspp(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Greedy k-means++ seeding (2 + log k local trials per centre)."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), x.dtype)
    centers[0] = x[rng.integers(n)]
    closest = _sq_dists(x, centers[:1])[:, 0]
    for i in range(1, k):
        total = closest.sum()
        if total <= 0.0:  # every point already sits on a centre
            cand = rng.integers(n, size=trials)
        else:
            cand = np.searchsorted(np.cumsum(closest), rng.random(trials) * total)
            cand = np.minimum(cand, n - 1)
        d_cand = np.minimum(closest[None, :], _sq_dists(x, x[cand]).T)
        best = int(np.argmin(d_cand.sum(1)))
        centers[i] = x[cand[best]]
        closest = d_cand[best]
    return centers


def _lloyd(x, centers, max_iter=300, tol=1e-4):
    tol = tol * float(np.mean(np.var(x, axis=0)))
    for _ in range(max_iter):
        labels = np.argmin(_sq_dists(x, centers), axis=1)
        new = centers.copy()
        counts = np.bincount(labels, minlength=len(centers))
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, x)
        filled = counts > 0
        new[filled] = sums[filled] / counts[filled, None]
        shift = float(((new - centers) ** 2).sum())
        centers = new
        if shift <= tol:
            break
    d = _sq_dists(x, centers)
    return centers, float(d.min(axis=1).sum())


def _inertia(x: np.ndarray, centers: np.ndarray) -> float:
    return float(_sq_dists(x, centers).min(axis=1).sum())


# The JAX package's MiniBatchKMeans settings (n_init, batch_size) and
# sklearn's defaults for the rest.
_MB_N_INIT = 3
_MB_BATCH = 4096
_MB_MAX_ITER = 100
_MB_MAX_NO_IMPROVEMENT = 10
_MB_REASSIGNMENT_RATIO = 0.01


def _minibatch_kmeans(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Mini-batch k-means, the algorithm of sklearn's ``MiniBatchKMeans.fit``
    (tol 0, unit weights): the best of ``_MB_N_INIT`` k-means++ seedings on
    random subsets of 3 ``_MB_BATCH`` points, by inertia on one more such
    subset; then batches drawn with replacement, each centre moved to the
    running mean of the points it was ever given, centres with under
    ``_MB_REASSIGNMENT_RATIO`` of the largest count moved to random batch
    points (every 10 k points seen, or while a centre has none), and a stop
    after ``_MB_MAX_NO_IMPROVEMENT`` steps without a new low of the smoothed
    batch inertia."""
    n = x.shape[0]
    batch = min(_MB_BATCH, n)
    init_size = min(max(3 * batch, 3 * k), n)
    valid = x[rng.integers(0, n, init_size)]
    best = None
    for _ in range(_MB_N_INIT):
        centers = _kmeanspp(x[rng.integers(0, n, init_size)], k, rng)
        inertia = _inertia(valid, centers)
        if best is None or inertia < best[1]:
            best = (centers, inertia)
    centers = best[0]
    counts = np.zeros(k)
    ewa = ewa_min = None
    no_improvement = since_reassign = 0
    alpha = min(batch * 2.0 / (n + 1), 1.0)
    for step in range(_MB_MAX_ITER * n // batch):
        xb = x[rng.integers(0, n, batch)]
        # Reassign this step every 10 k points seen, or while a centre has
        # never been given a point.
        since_reassign += batch
        reassign = bool((counts == 0).any()) or since_reassign >= 10 * k
        if reassign:
            since_reassign = 0
        d = _sq_dists(xb, centers)
        labels = d.argmin(axis=1)
        batch_inertia = float(d[np.arange(batch), labels].sum()) / batch
        # Running means: c <- (c * count + sum of its batch points) / new count.
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, xb)
        got = np.bincount(labels, minlength=k).astype(np.float64)
        hit = got > 0
        new = centers.copy()
        new[hit] = (centers[hit] * counts[hit, None] + sums[hit]) / (counts[hit] + got[hit])[:, None]
        counts += got
        if reassign:
            low = counts < _MB_REASSIGNMENT_RATIO * counts.max()
            if low.sum() > 0.5 * batch:  # at most half a batch of new centres
                low[np.argsort(counts)[int(0.5 * batch):]] = False
            if low.any():
                new[low] = xb[rng.choice(batch, size=int(low.sum()), replace=False)]
                counts[low] = counts[~low].min()
        centers = new
        if step == 0:  # the first batch measures the seeding, not a step
            continue
        ewa = batch_inertia if ewa is None else ewa * (1 - alpha) + batch_inertia * alpha
        if ewa_min is None or ewa < ewa_min:
            no_improvement, ewa_min = 0, ewa
        else:
            no_improvement += 1
            if no_improvement >= _MB_MAX_NO_IMPROVEMENT:
                break
    return centers


def _exact_kmeans(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Best inertia of 10 k-means++ + Lloyd runs over every point (the JAX
    package's ``KMeans(n_init=10)``)."""
    best = None
    for _ in range(10):
        centers, inertia = _lloyd(x, _kmeanspp(x, k, rng))
        if best is None or inertia < best[1]:
            best = (centers, inertia)
    return best[0]


def kmeans_centers(x: np.ndarray, k: int, seed: int) -> np.ndarray:
    """k cluster centres of the rows of x, as float32, seeded by ``seed``.
    As in the JAX package: with no more points than k, the points tiled;
    above 20,000 points, mini-batch k-means (3 seedings, batches of 4,096);
    else the best of 10 k-means++ + Lloyd runs."""
    if x.shape[0] <= k:
        reps = -(-k // x.shape[0])
        return np.tile(x, (reps, 1))[:k]
    xd = np.asarray(x, np.float64)
    rng = np.random.default_rng(seed)
    if x.shape[0] > 20_000:
        centers = _minibatch_kmeans(xd, k, rng)
    else:
        centers = _exact_kmeans(xd, k, rng)
    return centers.astype(np.float32)


def init_inducing(
    spec: ModelSpec,
    data_dict: Optional[Dict[str, dict]],
    *,
    data_init: bool = True,
    grid_init: bool = False,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, ModelSpec]:
    """Xtilde (V, m_X, D), Gtilde (m_G, D). ``grid_init`` may round m up to a
    square and return an updated spec."""
    rng = rng or np.random.default_rng(seed)
    V, D = spec.n_views, spec.n_spatial_dims

    if data_init and data_dict is not None:
        Xtilde = np.zeros((V, spec.m_X_per_view, D), np.float32)
        for v in range(V):
            pieces = []
            for mod in spec.modalities:
                x = _as_numpy(data_dict[mod.name]["spatial_coords"])
                lo, hi = view_slices(mod.n_samples)[v]
                pieces.append(x[lo:hi])
            xv = np.concatenate(pieces, axis=0).astype(np.float32)
            Xtilde[v] = kmeans_centers(xv, spec.m_X_per_view, seed + v)
        all_x = np.concatenate(
            [_as_numpy(data_dict[m]["spatial_coords"]) for m in spec.modality_names],
            axis=0,
        ).astype(np.float32)
        Gtilde = kmeans_centers(all_x, spec.m_G, seed + 1000)
        return Xtilde, Gtilde, spec

    if grid_init and data_dict is not None:
        first = _as_numpy(data_dict[spec.modality_names[0]]["spatial_coords"])
        lows, highs = first.min(0), first.max(0)
        if D == 1:
            grid = np.linspace(lows[0], highs[0], spec.m_G).reshape(-1, 1)
            grid = grid.astype(np.float32)
            m = spec.m_G
        elif D == 2:
            numticks = int(np.ceil(np.sqrt(spec.m_G)))  # m rounds up to a square
            m = numticks**2
            x1 = np.linspace(lows[0], highs[0], numticks)
            x2 = np.linspace(lows[1], highs[1], numticks)
            G1, G2 = np.meshgrid(x1, x2)
            grid = np.vstack([G1.ravel(), G2.ravel()]).T.astype(np.float32)
        else:
            raise ValueError("grid_init supports 1 or 2 spatial dims")
        Xtilde = np.tile(grid[None], (V, 1, 1))
        spec = spec.replace(m_G=m, m_X_per_view=m)
        return Xtilde, grid, spec

    Xtilde = rng.standard_normal((V, spec.m_X_per_view, D)).astype(np.float32)
    Gtilde = rng.standard_normal((spec.m_G, D)).astype(np.float32)
    return Xtilde, Gtilde, spec


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


def init_params(
    spec: ModelSpec,
    data_dict: Optional[Dict[str, dict]] = None,
    *,
    data_init: bool = True,
    grid_init: bool = False,
    seed: int = 0,
    fixed_warp_kernel_variances=None,
    fixed_warp_kernel_lengthscales=None,
    fixed_data_kernel_lengthscales=None,
    device=None,
) -> Tuple[dict, dict, ModelSpec]:
    """Build (params, consts, possibly-updated spec) as tensors on ``device``
    (the GPU unless ``device="cpu"``; raises without a card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    V, D = spec.n_views, spec.n_spatial_dims

    Xtilde, Gtilde, spec = init_inducing(
        spec, data_dict, data_init=data_init, grid_init=grid_init, seed=seed, rng=rng
    )
    m_X, m_G = spec.m_X_per_view, spec.m_G

    params: dict = {}
    consts: dict = {}

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    params["noise_variance"] = randn(spec.n_noise_variance_params) - 1.0

    if spec.fixed_warp_kernel_variances:
        consts["warp_kernel_variances"] = np.log(
            np.asarray(fixed_warp_kernel_variances, np.float32)
        )
    else:
        params["warp_kernel_variances"] = np.zeros(V, np.float32)

    if spec.fixed_warp_kernel_lengthscales:
        consts["warp_kernel_lengthscales"] = np.log(
            np.asarray(fixed_warp_kernel_lengthscales, np.float32)
        )
    else:
        params["warp_kernel_lengthscales"] = np.zeros(V, np.float32) + np.float32(
            np.log(10.0)
        )

    if spec.fixed_data_kernel_lengthscales:
        consts["data_kernel_lengthscale"] = np.log(
            np.asarray(fixed_data_kernel_lengthscales, np.float32).reshape(-1)
        )
    else:
        params["data_kernel_lengthscale"] = randn(1)

    params["data_kernel_variance"] = randn(1)

    eyeVDD = np.tile(np.eye(D, dtype=np.float32)[None], (V, 1, 1))
    if spec.mean_function == "identity_fixed":
        consts["mean_slopes"] = eyeVDD
        consts["mean_intercepts"] = np.zeros((V, D), np.float32)
    elif spec.mean_function == "identity_initialized":
        params["mean_slopes"] = randn(V, D, D)
        params["mean_intercepts"] = np.zeros((V, D), np.float32)
    else:  # linear mean, learned around identity
        params["mean_slopes"] = eyeVDD.copy()
        params["mean_intercepts"] = 0.1 * randn(V, D)

    def variational_factor(a: np.ndarray) -> np.ndarray:
        """The initial variational factor. Square mode stores the raw
        0.1 * randn draw; triangular mode chol(a a^T + jitter I), taken in
        float64 on the host, so that both start from one q; whitened mode
        the identity (the posterior covariance equals the prior's)."""
        if spec.whitened_variational:
            eye = np.eye(a.shape[-1], dtype=np.float32)
            return np.broadcast_to(eye, a.shape).copy()
        if not spec.triangular_variational:
            return a
        m = a @ np.swapaxes(a, -1, -2)
        diag_mean = np.maximum(
            1.0, np.trace(m, axis1=-2, axis2=-1).astype(np.float64) / m.shape[-1]
        )
        eye = np.eye(m.shape[-1], dtype=np.float64)
        jit = spec.diagonal_offset * diag_mean[..., None, None] * eye
        return np.linalg.cholesky(m.astype(np.float64) + jit).astype(np.float32)

    params["Xtilde"] = Xtilde
    params["Gtilde"] = Gtilde
    # Whitened mode stores w = L^-1 (u - mu_z): zero is the prior mean.
    params["delta_G"] = np.zeros_like(Xtilde) if spec.whitened_variational else Xtilde.copy()
    params["Omega_sqt_G"] = variational_factor(0.1 * randn(V, D, m_X, m_X))

    params["Omega_sqt_F"] = {}
    params["delta_F"] = {}
    params["W"] = {}
    for mod in spec.modalities:
        L = mod.n_latent
        params["Omega_sqt_F"][mod.name] = variational_factor(0.1 * randn(L, m_G, m_G))
        params["delta_F"][mod.name] = randn(m_G, L)
        if mod.use_lmc:
            params["W"][mod.name] = randn(L, mod.n_outputs)

    return _to_tensors(params, device), _to_tensors(consts, device), spec


def merge_hyperparams(params: dict, consts: dict) -> dict:
    """Single namespace view over trainable + frozen leaves."""
    merged = dict(params)
    merged.update(consts)
    return merged
