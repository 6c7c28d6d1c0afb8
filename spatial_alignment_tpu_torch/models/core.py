"""GPSA core in PyTorch: factor pass, warp layer, data layer, ELBO.

Counterpart of ``spatial_alignment_tpu/models/core.py``, with the merged
and the per-modality factor dispatch, in the square, triangular and whitened variational
parameterizations, with the data layer's point-axis chunking
(``spec.data_chunk_size``), minibatch SVI (``minibatch_spec``,
``subsample_batch``, ``negative_elbo_minibatch``) and imputation at chosen
aligned coordinates (``impute_at``, ``forward(G_test=)``).
The JAX package ``vmap``s its per-view function; here the view axis is an
explicit leading batch dim. Fixed (template) views are left out of the
factor pass and the KL by static indexing, and their slots in the per-view
outputs are filled out of place (``torch.stack``), so nothing saved for
backward is written in place.

Kernel opt-ins: ``spec.cholesky_impl``, ``spec.quad_diag_impl`` and
``spec.fused_factor_inverse`` reach every place the JAX package passes them
(``svgp_mean_var``, ``_kuu_inverses``, ``compute_factors``, the KL); see
:mod:`..ops.linalg` and :mod:`..ops.quad` for what each launches. The
cross-Grams of the warp and data layers go through :func:`..ops.gram.gram`,
which takes the Gram kernel under ``set_gram_force(True)``.

Precision names: ``spec.svgp_matmul_precision`` and
``spec.svgp_variance_precision`` reach ``svgp_mean_var`` from every caller,
as in the JAX package (its ``core.py:204-268``): the variance's products
(the quad-diag and, in the solve modes, ``alphaT @ Kuu_chol``) at the
variance name, the mean's at the matmul name, through
:func:`..ops.precision.matmul` (``default`` is one cuBLAS TF32 pass on the
card, in both directions), and the products JAX pins to ``highest`` at
``highest`` through the same primitive: on the card every one of them runs
in its name's mode whatever PyTorch's process-wide TF32 setting reads when
it is formed.

Monte-Carlo noise: ``warp_layer``, ``data_layer``, ``impute_at``,
``forward``, ``negative_elbo`` and ``negative_elbo_minibatch`` take the
standard-normal draws (and the last the subsample's indices) as optional
tensors (the tests pass the JAX package's draws) and otherwise draw them
from the given ``torch.Generator``. Everything is float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import quad
from ..ops.gram import gram
from ..ops.kernels import get_kernel
from ..ops.linalg import (
    cholesky_solve,
    factor_psd_cholesky,
    jittered_cholesky,
    jittered_cholesky_inverse,
    joint_factor_cholesky,
    joint_factor_cholesky_inverse,
    kl_mvn_chol,
    kl_whitened,
    tri_inverse,
    tri_solve,
)
from ..ops.precision import matmul
from .spec import ModelSpec

_LOG_2PI = math.log(2.0 * math.pi)
# The warp temperature: a float, or a 0-d float32 tensor on the batch's device.
Temperature = Union[float, torch.Tensor]
# Floor for marginal variances before sqrt: d sqrt(u)/du is infinite at 0.
_VAR_FLOOR = 1e-10


class WarpAux(NamedTuple):
    """Warp-layer intermediates needed by the KL term."""

    Kuu_chol: torch.Tensor  # (V, m_X, m_X)
    Omega_tril: torch.Tensor  # (V, D, m_X, m_X)
    mu_z: torch.Tensor  # (V, m_X, D)
    Kuu_inv: Optional[torch.Tensor] = None  # (V, m_X, m_X)


class DataAux(NamedTuple):
    """Data-layer intermediates needed by the KL term."""

    Kuu_chol: torch.Tensor  # (m_G, m_G)
    Omega_tril: Dict[str, torch.Tensor]  # {mod: (L, m_G, m_G)}
    Kuu_inv: Optional[torch.Tensor] = None  # (m_G, m_G)


class ForwardResult(NamedTuple):
    G_means: Dict[str, torch.Tensor]  # {mod: (V, Np, D)}
    G_samples: Dict[str, torch.Tensor]  # {mod: (S, V, Np, D)}
    F_latent_samples: Dict[str, torch.Tensor]  # {mod: (S, V, Np, L)}
    F_observed_samples: Dict[str, torch.Tensor]  # {mod: (S, V, Np, P)}
    warp_aux: WarpAux
    data_aux: DataAux
    F_latent_samples_test: Optional[Dict[str, torch.Tensor]] = None  # {mod: (S, n_test, L)}
    F_observed_samples_test: Optional[Dict[str, torch.Tensor]] = None  # {mod: (S, n_test, P)}


# ---------------------------------------------------------------------------
# SVGP predictive: mean and diagonal variance
# ---------------------------------------------------------------------------


def _quad_diag(
    xT: torch.Tensor, factors: torch.Tensor, impl: Optional[str] = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Per-point quadratic-form diagonals sum_k (xT @ factors)^2 -> (..., B, N),
    the product at ``precision``.

    xT (..., N, m); factors (B, m, m) or (..., B, m, m) per output-channel
    factors. ``impl="pallas"`` takes the kernels of :mod:`..ops.quad`."""
    if impl == "pallas":
        return quad.quad_diag(xT, factors, precision)
    return quad.quad_diag_plain(xT, factors, precision)


def svgp_mean_var(
    kff_diag: torch.Tensor,  # (..., N)
    Kuf: torch.Tensor,  # (..., m, N)
    Kuu_chol: torch.Tensor,  # (..., m, m)
    mu_x,  # (..., N, C) or 0
    mu_z,  # (..., m, C) or 0
    delta: torch.Tensor,  # (..., m, C)
    Omega_tril: torch.Tensor,  # (..., B, m, m)
    diagonal_offset: float,
    solve_mode: str = "solve",
    Kuu_inv: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    quad_impl: Optional[str] = None,
    whitened: bool = False,
    matmul_precision: str = "highest",
    variance_precision: str = "follow",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SVGP marginal posterior at the Kuf columns.

    Returns mu_tilde (..., N, C) and Sigma_tilde (..., B, N). ``solve_mode``
    as in ``ModelSpec.svgp_solve_mode``; ``Kuu_inv`` is a precomputed
    chol(Kuu)^-1 for the modes that use it. ``impl`` routes the triangular
    solves and ``quad_impl`` the quadratic forms (``ModelSpec.cholesky_impl``
    and ``quad_diag_impl``).

    ``whitened``: (delta, Omega_tril) describe the whitened state
    w = L^-1 (u - mu_z), so mu = mu_x + B^T delta and the variance's
    quadratic form runs on B^T and Omega_tril, for B = L^-1 Kuf: one
    width-N triangular solve (``Linv @ Kuf`` under "inverse"), whose column
    norms are also diag(Kfu Kuu^-1 Kuf); ``mu_z`` is unused.

    ``matmul_precision`` sets the mean's products and ``variance_precision``
    (``follow``: the matmul name) the variance's, as ``ModelSpec``'s
    ``svgp_*_precision`` (:mod:`..ops.precision`); ``Linv @ Kuf``, ``C_om``,
    ``alphaT`` and the whitened ``B_w`` run at ``highest`` (fp32), as JAX
    pins them.
    """
    if variance_precision == "follow":
        variance_precision = matmul_precision
    if solve_mode == "inverse" or (solve_mode == "mixed" and not whitened):
        Linv = Kuu_inv if Kuu_inv is not None else tri_inverse(Kuu_chol, impl=impl)
    if whitened:
        if solve_mode == "inverse":
            B_w = matmul(Linv, Kuf, "highest")  # (..., m, N)
        else:
            B_w = tri_solve(Kuu_chol, Kuf, impl=impl)  # the only solve
        alphaT = B_w.transpose(-1, -2)  # (..., N, m)
        aKa = torch.square(alphaT).sum(dim=-1)
        mu_tilde = mu_x + matmul(alphaT, delta, matmul_precision)
        aOa = _quad_diag(alphaT, Omega_tril, quad_impl, variance_precision)
    elif solve_mode == "mixed":
        half = matmul(Linv, Kuf, "highest")  # (..., m, N) = L^-1 Kuf
        aKa = torch.square(half).sum(dim=-2)  # diag(Kfu Kuu^-1 Kuf)
        # Mean through the narrow (width-C) backward-stable solve.
        v = cholesky_solve(Kuu_chol, delta - mu_z, impl=impl)  # (..., m, C)
        mu_tilde = mu_x + matmul(Kuf.transpose(-1, -2), v, matmul_precision)
        # alpha^T Omega_L = (L^-1 Kuf)^T (L^-1 Omega_L): fold Linv into the
        # m x m channel factors so alpha^T is never formed.
        C_om = matmul(Linv.unsqueeze(-3), Omega_tril, "highest")  # (..., B, m, m)
        aOa = _quad_diag(half.transpose(-1, -2), C_om, quad_impl, variance_precision)
    elif solve_mode == "inverse":
        half = matmul(Linv, Kuf, "highest")
        alphaT = matmul(half.transpose(-1, -2), Linv, "highest")  # (..., N, m) = Kfu Kuu^-1
        aKa = torch.square(half).sum(dim=-2)
        mu_tilde = mu_x + matmul(alphaT, delta - mu_z, matmul_precision)
        aOa = _quad_diag(alphaT, Omega_tril, quad_impl, variance_precision)
    elif solve_mode in ("solve", "kl_inverse"):
        alpha = cholesky_solve(Kuu_chol, Kuf, impl=impl)  # (..., m, N)
        alphaT = alpha.transpose(-1, -2)
        a_t_K = matmul(alphaT, Kuu_chol, variance_precision)
        aKa = torch.square(a_t_K).sum(dim=-1)
        mu_tilde = mu_x + matmul(alphaT, delta - mu_z, matmul_precision)
        aOa = _quad_diag(alphaT, Omega_tril, quad_impl, variance_precision)
    else:
        raise ValueError(f"unknown solve mode {solve_mode!r}")
    sigma = (
        kff_diag.unsqueeze(-2) - aKa.unsqueeze(-2) + aOa + 2.0 * diagonal_offset
    )
    return mu_tilde, sigma


def _precisions(spec: ModelSpec) -> dict:
    """``svgp_mean_var``'s precision names from the spec."""
    return {"matmul_precision": spec.svgp_matmul_precision,
            "variance_precision": spec.svgp_variance_precision}


# ---------------------------------------------------------------------------
# Factor pass
# ---------------------------------------------------------------------------


class FactorPass(NamedTuple):
    """Every Cholesky factor a step needs, from one probe + one final call."""

    warp_Kuu_chol: torch.Tensor  # (Va, m_X, m_X), active views only
    warp_Om_tril: torch.Tensor  # (Va, D, m_X, m_X)
    data_Kuu_chol: torch.Tensor  # (m_G, m_G)
    data_Om_tril: Dict[str, torch.Tensor]  # {mod: (L, m_G, m_G)}
    warp_Kuu_inv: Optional[torch.Tensor] = None  # (Va, m_X, m_X)
    data_Kuu_inv: Optional[torch.Tensor] = None  # (m_G, m_G)


def _active_views(spec: ModelSpec):
    return [v for v in range(spec.n_views) if not spec.fixed_view_mask[v]]


def _take_active(spec: ModelSpec, arr: torch.Tensor, active) -> torch.Tensor:
    """The active views' rows. Static indices: stacked slices, so no index
    tensor is copied to the device on each step."""
    if len(active) == spec.n_views:
        return arr
    return torch.stack([arr[v] for v in active])


def _warp_grams(spec: ModelSpec, hp: dict, active):
    """(Kuu (Va, m_X, m_X), Omega_sqt (Va, D, m_X, m_X)) for active views."""
    kern = get_kernel(spec.kernel_warp)
    Xt = _take_active(spec, hp["Xtilde"], active)
    ls = _take_active(spec, hp["warp_kernel_lengthscales"], active)
    var = _take_active(spec, hp["warp_kernel_variances"], active)
    Kuu = kern(Xt, Xt, ls[:, None, None], var[:, None, None])
    return Kuu, _take_active(spec, hp["Omega_sqt_G"], active)


def _data_gram(spec: ModelSpec, hp: dict) -> torch.Tensor:
    kern = get_kernel(spec.kernel_data)
    return kern(
        hp["Gtilde"], hp["Gtilde"], hp["data_kernel_lengthscale"], hp["data_kernel_variance"]
    )


def _split_sizes(sizes, slab):
    parts, off = [], 0
    for s in sizes:
        parts.append(slab[off : off + s])
        off += s
    return parts


def _wants_kuu_inverse(spec: ModelSpec) -> bool:
    """Whether this spec's solve mode consumes an explicit chol(Kuu)^-1:
    the whitened KL has no prior solve, and under "kl_inverse" and "mixed"
    the whitened predictive takes triangular solves, so whitened mode wants
    one only under "inverse"."""
    if spec.whitened_variational:
        return spec.svgp_solve_mode == "inverse"
    return spec.svgp_solve_mode in ("inverse", "kl_inverse", "mixed")


def _predictive_wants_inverse(spec: ModelSpec) -> bool:
    """Whether the SVGP predictive itself applies chol(Kuu)^-1 (see
    :func:`svgp_mean_var`)."""
    mode = spec.svgp_solve_mode
    return mode == "inverse" or (mode == "mixed" and not spec.whitened_variational)


def _tril_mode(spec: ModelSpec) -> bool:
    return spec.triangular_variational or spec.whitened_variational


def omega_tril(spec: ModelSpec, Om_sqt: torch.Tensor, eps: float) -> torch.Tensor:
    """Cholesky factor of the variational covariance from its stored factor:
    chol(Om_sqt Om_sqt^T + eps I) in square mode, the stored factor's lower
    triangle in triangular and whitened modes (no factorization)."""
    if _tril_mode(spec):
        return torch.tril(Om_sqt)
    return factor_psd_cholesky(Om_sqt, eps)


def _kuu_inverses(spec: ModelSpec, L_w, L_d, Va: int, m_X: int, m_G: int):
    """(warp, data) explicit Kuu-Cholesky inverses, merged when sizes match."""
    if not _wants_kuu_inverse(spec):
        return None, None
    impl = spec.cholesky_impl
    if m_X == m_G and Va > 0:
        inv = tri_inverse(torch.cat([L_w, L_d[None]], dim=0), impl=impl)
        return inv[:Va], inv[Va]
    inv_w = tri_inverse(L_w, impl=impl) if Va else None
    return inv_w, tri_inverse(L_d, impl=impl)


def compute_factors(spec: ModelSpec, hp: dict) -> FactorPass:
    """One batched factorization pass over all of the step's m x m matrices.

    The active views' warp Grams and the data Gram share one jitter probe;
    in square mode they and every variational-covariance product share one
    final factorization (two groups when m_X != m_G). In triangular and
    whitened modes the variational factors are stored as their Cholesky
    factors, so only the Kuu Grams are factored (and inverted, where the
    solve mode wants it, in the same fused call under
    ``fused_factor_inverse="fused"``).

    ``spec.merged_factor_dispatch=False`` (set by
    :func:`..parallel.distribute` when the model axis shards the
    variational state, and carried by checkpoints) factors each modality's
    ``Omega_sqt_F`` products in a call of their own; the other slabs merge
    as before, and the Kuu inverses take their own call.
    """
    eps = spec.diagonal_offset
    active = _active_views(spec)
    Va = len(active)
    D = spec.n_spatial_dims

    Kuu_w, Om_w_sqt = _warp_grams(spec, hp, active)
    Kuu_d = _data_gram(spec, hp)
    m_X, m_G = Kuu_w.shape[-1], Kuu_d.shape[-1]
    om_d_list = [hp["Omega_sqt_F"][mod.name] for mod in spec.modalities]
    om_d_sizes = [s.shape[0] for s in om_d_list]
    mod_names = [mod.name for mod in spec.modalities]

    if _tril_mode(spec):
        Om_w_tril = omega_tril(spec, Om_w_sqt, eps)
        Om_d_tril = {n: omega_tril(spec, s, eps) for n, s in zip(mod_names, om_d_list)}
        if m_X == m_G and Va > 0:
            slab = torch.cat([Kuu_w, Kuu_d[None]], dim=0)
            if _wants_kuu_inverse(spec):
                L, inv = jittered_cholesky_inverse(
                    slab, eps, impl=spec.cholesky_impl, fused=spec.fused_factor_inverse
                )
                return FactorPass(L[:Va], Om_w_tril, L[Va], Om_d_tril, inv[:Va], inv[Va])
            L = jittered_cholesky(slab, eps)
            L_w, L_d = L[:Va], L[Va]
        else:
            L_w = jittered_cholesky(Kuu_w, eps) if Va else Kuu_w
            L_d = jittered_cholesky(Kuu_d, eps)
        inv_w, inv_d = _kuu_inverses(spec, L_w, L_d, Va, m_X, m_G)
        return FactorPass(L_w, Om_w_tril, L_d, Om_d_tril, inv_w, inv_d)

    Om_w_flat = Om_w_sqt.reshape(Va * D, m_X, m_X)
    if not spec.merged_factor_dispatch:
        # Each modality's Omega_sqt_F slab in its own call (a rank of a
        # model-sharded model holds its own latents of it); the Grams and the
        # warp products still share one.
        Om_d_tril = {n: factor_psd_cholesky(s, eps) for n, s in zip(mod_names, om_d_list)}
        if m_X == m_G and Va > 0:
            Lg, Lp = joint_factor_cholesky(torch.cat([Kuu_w, Kuu_d[None]], dim=0), Om_w_flat, eps)
            L_w, L_d = Lg[:Va], Lg[Va]
            Om_w_tril = Lp.reshape(Va, D, m_X, m_X)
        else:
            if Va:
                L_w, Om_w_t = joint_factor_cholesky(Kuu_w, Om_w_flat, eps)
                Om_w_tril = Om_w_t.reshape(Va, D, m_X, m_X)
            else:
                L_w, Om_w_tril = Kuu_w, Om_w_sqt
            L_d = jittered_cholesky(Kuu_d, eps)
        inv_w, inv_d = _kuu_inverses(spec, L_w, L_d, Va, m_X, m_G)
        return FactorPass(L_w, Om_w_tril, L_d, Om_d_tril, inv_w, inv_d)

    Om_d_flat = torch.cat(om_d_list, dim=0)
    if m_X == m_G and Va > 0:
        n_inv = (Va + 1) if _wants_kuu_inverse(spec) else 0
        Lg, Lp, inv = joint_factor_cholesky_inverse(
            torch.cat([Kuu_w, Kuu_d[None]], dim=0),
            torch.cat([Om_w_flat, Om_d_flat], dim=0),
            eps,
            impl=spec.cholesky_impl,
            n_inv=n_inv,
            fused=spec.fused_factor_inverse,
        )
        L_w, L_d = Lg[:Va], Lg[Va]
        Om_w_tril = Lp[: Va * D].reshape(Va, D, m_X, m_X)
        Om_d_tril = dict(zip(mod_names, _split_sizes(om_d_sizes, Lp[Va * D :])))
        if n_inv:
            return FactorPass(L_w, Om_w_tril, L_d, Om_d_tril, inv[:Va], inv[Va])
        return FactorPass(L_w, Om_w_tril, L_d, Om_d_tril)
    if Va:
        L_w, Om_w_t = joint_factor_cholesky(Kuu_w, Om_w_flat, eps)
        Om_w_tril = Om_w_t.reshape(Va, D, m_X, m_X)
    else:
        L_w, Om_w_tril = Kuu_w, Om_w_sqt
    Lg_d, Lp_d = joint_factor_cholesky(Kuu_d[None], Om_d_flat, eps)
    L_d = Lg_d[0]
    Om_d_tril = dict(zip(mod_names, _split_sizes(om_d_sizes, Lp_d)))
    inv_w, inv_d = _kuu_inverses(spec, L_w, L_d, Va, m_X, m_G)
    return FactorPass(L_w, Om_w_tril, L_d, Om_d_tril, inv_w, inv_d)


# ---------------------------------------------------------------------------
# Warp layer
# ---------------------------------------------------------------------------


def _concat_modalities(spec: ModelSpec, batch):
    """Stack per-modality padded arrays along the point axis: (V, Ntot, ...)."""
    coords = torch.cat([batch[m]["coords"] for m in spec.modality_names], dim=1)
    mask = torch.cat([batch[m]["mask"] for m in spec.modality_names], dim=1)
    return coords, mask


def _split_modalities(spec: ModelSpec, arr: torch.Tensor, axis: int):
    """Inverse of _concat_modalities along the given axis."""
    pieces, off = {}, 0
    for mod in spec.modalities:
        pieces[mod.name] = arr.narrow(axis, off, mod.n_padded)
        off += mod.n_padded
    return pieces


def _fill_views(spec: ModelSpec, active, values: Optional[torch.Tensor], filler: torch.Tensor):
    """(V, ...) from the active views' ``values`` and ``filler`` elsewhere."""
    if values is None:
        return None
    pos = {v: i for i, v in enumerate(active)}
    return torch.stack(
        [values[pos[v]] if v in pos else filler for v in range(spec.n_views)]
    )


def warp_layer(
    spec: ModelSpec,
    hp: dict,
    X_all: torch.Tensor,  # (V, Ntot, D) padded observed coords
    S: int,
    temperature: Temperature = 1.0,
    noise: Optional[torch.Tensor] = None,  # (S, V, Ntot, D)
    factors: Optional[Tuple] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, WarpAux]:
    """Per-view warp GP posterior + S reparameterized samples.

    Returns (G_mean (V, Ntot, D), G_samples (S, V, Ntot, D), aux).
    ``factors`` = (Kuu_chol (Va, m, m), Om_tril (Va, D, m, m), Kuu_inv) for
    the active views, from :func:`compute_factors`.
    """
    if factors is None:
        fp = compute_factors(spec, hp)
        factors = (fp.warp_Kuu_chol, fp.warp_Om_tril, fp.warp_Kuu_inv)
    eps = spec.diagonal_offset
    active = _active_views(spec)
    Va = len(active)
    V, Ntot, D = X_all.shape
    dt, dev = X_all.dtype, X_all.device
    L_a, Om_a, Linv_a = factors[0], factors[1], factors[2] if len(factors) > 2 else None
    if _predictive_wants_inverse(spec) and Linv_a is None and Va:
        Linv_a = tri_inverse(L_a, impl=spec.cholesky_impl)

    m = hp["Xtilde"].shape[1]
    eye_m = torch.eye(m, dtype=dt, device=dev)
    if Va:
        tk = lambda a: _take_active(spec, a, active)
        Xt, Xv = tk(hp["Xtilde"]), tk(X_all)
        ls, var = tk(hp["warp_kernel_lengthscales"]), tk(hp["warp_kernel_variances"])
        slope, intercept = tk(hp["mean_slopes"]), tk(hp["mean_intercepts"])
        Kuf = gram(Xt, Xv, ls, var, spec.kernel_warp)  # (Va, m, Ntot)
        mu_x = Xv @ slope + intercept[:, None, :]  # (Va, Ntot, D)
        mu_z_a = Xt @ slope + intercept[:, None, :]  # (Va, m, D)
        kff = torch.exp(var)[:, None] * torch.ones(Va, Ntot, dtype=dt, device=dev)
        mu_a, sig_a = svgp_mean_var(
            kff, Kuf, L_a, mu_x, mu_z_a, tk(hp["delta_G"]), Om_a, eps,
            solve_mode=spec.svgp_solve_mode, Kuu_inv=Linv_a,
            impl=spec.cholesky_impl, quad_impl=spec.quad_diag_impl,
            whitened=spec.whitened_variational, **_precisions(spec),
        )
    if Va == V:
        mu_tilde, sigma, mu_z = mu_a, sig_a, mu_z_a
        Kuu_chol, Om_tril, Kuu_inv = L_a, Om_a, Linv_a
    else:
        # Fixed (template) views: their outputs are overwritten with X_all
        # below and their KL lanes are excluded, so they get finite fillers
        # (identity factors) instead of a factorization.
        fill = lambda vals, filler: _fill_views(spec, active, vals, filler)
        zeros_n = torch.zeros(Ntot, D, dtype=dt, device=dev)
        mu_tilde = fill(mu_a, zeros_n) if Va else zeros_n.expand(V, Ntot, D)
        sigma = (
            fill(sig_a, torch.ones(D, Ntot, dtype=dt, device=dev))
            if Va
            else torch.ones(V, D, Ntot, dtype=dt, device=dev)
        )
        Kuu_chol = fill(L_a, eye_m) if Va else eye_m.expand(V, m, m)
        eye_om = eye_m.expand(D, m, m)
        Om_tril = fill(Om_a, eye_om) if Va else eye_om.expand(V, D, m, m)
        Kuu_inv = fill(Linv_a, eye_m) if Linv_a is not None else None
        zeros_m = torch.zeros(m, D, dtype=dt, device=dev)
        mu_z = fill(mu_z_a, zeros_m) if Va else zeros_m.expand(V, m, D)
    sigma = sigma.transpose(-1, -2)  # (V, Ntot, D)

    if spec.reference_sample_scale:
        scale = sigma  # the reference passes the variance as the Normal scale
    else:
        scale = torch.sqrt(torch.clamp_min(sigma, _VAR_FLOOR))
    # Warp-noise tempering; 1.0 = exact ELBO. A 0-d tensor multiplies as the
    # float of the same value does, so a captured step can read it per replay.
    scale = scale * temperature

    if noise is None:
        noise = torch.randn((S,) + tuple(mu_tilde.shape), generator=generator, dtype=dt, device=dev)
    samples = mu_tilde[None] + scale[None] * noise  # (S, V, Ntot, D)

    if spec.any_fixed_view:
        fixed = spec.fixed_view_mask
        mu_tilde = torch.stack([X_all[v] if fixed[v] else mu_tilde[v] for v in range(V)])
        samples = torch.stack(
            [X_all[v].expand(S, Ntot, D) if fixed[v] else samples[:, v] for v in range(V)],
            dim=1,
        )

    return mu_tilde, samples, WarpAux(Kuu_chol, Om_tril, mu_z, Kuu_inv)


# ---------------------------------------------------------------------------
# Data layer
# ---------------------------------------------------------------------------


def _data_factors(spec: ModelSpec, hp: dict, factors):
    """The data layer's (Kuu chol, {mod: Omega tril}, Kuu inverse), from
    ``factors`` or from :func:`compute_factors` (whose unmerged branch gives
    each modality's Omega_sqt_F slab its own call)."""
    if factors is None:
        fp = compute_factors(spec, hp)
        factors = (fp.data_Kuu_chol, fp.data_Om_tril, fp.data_Kuu_inv)
    L_F, Om_by_mod = factors[0], factors[1]
    Linv_F = factors[2] if len(factors) > 2 else None
    if _predictive_wants_inverse(spec) and Linv_F is None:
        Linv_F = tri_inverse(L_F, impl=spec.cholesky_impl)
    return L_F, Om_by_mod, Linv_F


def _pick_chunk(n: int, requested) -> Optional[int]:
    """Largest divisor of n that is <= the requested chunk size (None = no
    chunking, or when n already fits in one chunk)."""
    if requested is None or n <= requested:
        return None
    nc = -(-n // requested)
    while n % nc:
        nc += 1
    return n // nc


def _data_moments(spec, hp, Kuf, L_F, Linv_F, delta, Om_tril):
    """Latent SVGP mean and floored variance, both (S, n, L), from the
    cross-Gram Kuf (S, m_G, n) at n points."""
    var = hp["data_kernel_variance"]
    kff = torch.exp(var) * torch.ones(
        Kuf.shape[:-2] + Kuf.shape[-1:], dtype=Kuf.dtype, device=Kuf.device
    )
    mu_t, sig = svgp_mean_var(
        kff, Kuf, L_F, 0.0, 0.0, delta, Om_tril, spec.diagonal_offset,
        solve_mode=spec.svgp_solve_mode, Kuu_inv=Linv_F,
        impl=spec.cholesky_impl, quad_impl=spec.quad_diag_impl,
        whitened=spec.whitened_variational, **_precisions(spec),
    )
    return mu_t, torch.clamp_min(sig.transpose(-1, -2), _VAR_FLOOR)


def _over_points(spec: ModelSpec, hp: dict, G: torch.Tensor, per_chunk, *extra):
    """``per_chunk(Kuf, *extra)`` over the point axis (dim 1) of G (S, N, D)
    and of each ``extra`` (S, N, ...): whole, or in ``_pick_chunk`` pieces of
    ``spec.data_chunk_size`` (JAX ``core.py:783-796,857-865``). Returns
    ``per_chunk``'s tuple of (S, n, ...) tensors, joined along dim 1.

    Peak memory is the point of chunking: each chunk's intermediates,
    O(S L chunk m) through the variance's quadratic form, are recomputed in
    the backward instead of saved for all N points. Each chunk's Gram is
    made outside the recomputed region: its closed-form backward keeps it
    anyway, and recomputing it would launch the Gram kernel a second time.
    Under the restart ``vmap`` of ``fit_multistart`` nothing is recomputed
    (a recomputation would run outside the transform): the chunks bound the
    forward's working set, and the backward keeps every chunk's
    intermediates.
    """
    kern = lambda pts: gram(
        hp["Gtilde"], pts, hp["data_kernel_lengthscale"], hp["data_kernel_variance"],
        spec.kernel_data,
    )
    N = G.shape[1]
    chunk = _pick_chunk(N, spec.data_chunk_size)
    if chunk is None:
        return per_chunk(kern(G), *extra)
    outs = []
    for lo in range(0, N, chunk):
        Kuf = kern(G[:, lo : lo + chunk])
        args = (Kuf,) + tuple(e[:, lo : lo + chunk] for e in extra)
        if torch.is_grad_enabled() and not torch._C._functorch.is_batchedtensor(G):
            outs.append(checkpoint(per_chunk, *args, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(per_chunk(*args))
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def data_layer(
    spec: ModelSpec,
    hp: dict,
    G_samples: Dict[str, torch.Tensor],  # {mod: (S, V, Np, D)}
    noise: Optional[Dict[str, torch.Tensor]] = None,  # {mod: (S, V*Np, L)}
    factors: Optional[Tuple] = None,
    generator: Optional[torch.Generator] = None,
):
    """Multi-output data GP sampled at the warped coordinates.

    Returns ({mod: F_latent (S, V, Np, L)}, {mod: F_obs (S, V, Np, P)}, aux).
    """
    L_F, Om_by_mod, Linv_F = _data_factors(spec, hp, factors)
    F_latent, F_obs, Om_tril_F = {}, {}, {}
    for mod in spec.modalities:
        S, V, Np, D = G_samples[mod.name].shape
        N = V * Np
        G = G_samples[mod.name].reshape(S, N, D)
        Om_tril, delta = Om_by_mod[mod.name], hp["delta_F"][mod.name]
        # The noise is drawn for all N points before any chunking, so chunked
        # and unchunked runs see the same samples.
        eps_f = noise[mod.name] if noise is not None else torch.randn(
            (S, N, mod.n_latent), generator=generator, dtype=G.dtype, device=G.device
        )

        def sample(Kuf, eps_pts, Om_tril=Om_tril, delta=delta):
            mu_t, var_t = _data_moments(spec, hp, Kuf, L_F, Linv_F, delta, Om_tril)
            return (mu_t + torch.sqrt(var_t) * eps_pts,)

        (lat,) = _over_points(spec, hp, G, sample, eps_f)
        obs = lat @ hp["W"][mod.name] if mod.use_lmc else lat
        F_latent[mod.name] = lat.reshape(S, V, Np, mod.n_latent)
        F_obs[mod.name] = obs.reshape(S, V, Np, mod.n_outputs)
        Om_tril_F[mod.name] = Om_tril
    return F_latent, F_obs, DataAux(L_F, Om_tril_F, Linv_F)


def data_layer_moments(
    spec: ModelSpec,
    hp: dict,
    G_samples: Dict[str, torch.Tensor],  # {mod: (S, V, Np, D)}
    factors: Optional[Tuple] = None,
):
    """Per-point observed-output moments of the data GP (no sampling).

    Returns ({mod: mu_obs (S, V, Np, P)}, {mod: var_obs (S, V, Np, P)}, aux);
    under the LMC the observed moments are mu @ W and var @ W^2.
    """
    L_F, Om_by_mod, Linv_F = _data_factors(spec, hp, factors)
    mu_obs, var_obs, Om_tril_F = {}, {}, {}
    for mod in spec.modalities:
        S, V, Np, D = G_samples[mod.name].shape
        G = G_samples[mod.name].reshape(S, V * Np, D)
        Om_tril, delta = Om_by_mod[mod.name], hp["delta_F"][mod.name]
        mu_t, var_t = _over_points(
            spec, hp, G,
            lambda Kuf, Om_tril=Om_tril, delta=delta: _data_moments(
                spec, hp, Kuf, L_F, Linv_F, delta, Om_tril
            ),
        )
        if mod.use_lmc:
            W = hp["W"][mod.name]
            mu_o, var_o = mu_t @ W, var_t @ torch.square(W)
        else:
            mu_o, var_o = mu_t, var_t
        mu_obs[mod.name] = mu_o.reshape(S, V, Np, mod.n_outputs)
        var_obs[mod.name] = var_o.reshape(S, V, Np, mod.n_outputs)
        Om_tril_F[mod.name] = Om_tril
    return mu_obs, var_obs, DataAux(L_F, Om_tril_F, Linv_F)


def impute_at(
    spec: ModelSpec,
    hp: dict,
    data_aux: DataAux,
    G_test: Dict[str, torch.Tensor],  # {mod: (n_test, D)} or (1, n_test, D)
    S: int,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, torch.Tensor]] = None,  # {mod: (S, n_test, L)}
):
    """S samples of the outputs at caller-chosen aligned coordinates, from
    the data GP's factors in ``data_aux`` (JAX ``core.impute_at``): the
    rebuild of every view on one common grid, such as a dense 3-D grid.
    Accepts the reference's (1, n_test, D) layout. As in the JAX package the
    cross-Gram is the plain kernel function and the solves take no kernel
    opt-in; the quadratic form follows ``quad_diag_impl``.

    Returns ({mod: F_latent (S, n_test, L)}, {mod: F_observed (S, n_test, P)}).
    """
    kern = get_kernel(spec.kernel_data)
    ls, var = hp["data_kernel_lengthscale"], hp["data_kernel_variance"]
    F_latent, F_obs = {}, {}
    for mod in spec.modalities:
        Gt = G_test[mod.name]
        if Gt.dim() == 3:
            Gt = Gt[0]
        Kuf = kern(hp["Gtilde"], Gt, ls, var)  # (m_G, n_test)
        kff = torch.exp(var) * torch.ones(Gt.shape[0], dtype=Gt.dtype, device=Gt.device)
        mu_t, sig = svgp_mean_var(
            kff, Kuf, data_aux.Kuu_chol, 0.0, 0.0, hp["delta_F"][mod.name],
            data_aux.Omega_tril[mod.name], spec.diagonal_offset,
            solve_mode=spec.svgp_solve_mode, Kuu_inv=data_aux.Kuu_inv,
            quad_impl=spec.quad_diag_impl, whitened=spec.whitened_variational,
            **_precisions(spec),
        )
        eps_t = noise[mod.name] if noise is not None else torch.randn(
            (S,) + tuple(mu_t.shape), generator=generator, dtype=mu_t.dtype, device=mu_t.device
        )
        scale = torch.sqrt(torch.clamp_min(sig.transpose(-1, -2), _VAR_FLOOR))
        lat = mu_t[None] + scale[None] * eps_t
        F_latent[mod.name] = lat
        F_obs[mod.name] = lat @ hp["W"][mod.name] if mod.use_lmc else lat
    return F_latent, F_obs


# ---------------------------------------------------------------------------
# Forward + ELBO
# ---------------------------------------------------------------------------


def forward(
    spec: ModelSpec,
    hp: dict,
    batch,
    S: int = 1,
    temperature: Temperature = 1.0,
    *,
    generator: Optional[torch.Generator] = None,
    warp_noise: Optional[torch.Tensor] = None,
    data_noise: Optional[Dict[str, torch.Tensor]] = None,
    G_test: Optional[Dict[str, torch.Tensor]] = None,
    test_noise: Optional[Dict[str, torch.Tensor]] = None,
) -> ForwardResult:
    """Full two-layer forward pass with one shared factor pass; with
    ``G_test`` also :func:`impute_at` there (its noise drawn after the data
    layer's, or ``test_noise``)."""
    X_all, _ = _concat_modalities(spec, batch)
    fp = compute_factors(spec, hp)
    G_mean_all, G_sample_all, warp_aux = warp_layer(
        spec, hp, X_all, S, temperature, noise=warp_noise,
        factors=(fp.warp_Kuu_chol, fp.warp_Om_tril, fp.warp_Kuu_inv),
        generator=generator,
    )
    G_means = _split_modalities(spec, G_mean_all, axis=1)
    G_samples = _split_modalities(spec, G_sample_all, axis=2)
    F_latent, F_obs, data_aux = data_layer(
        spec, hp, G_samples, noise=data_noise,
        factors=(fp.data_Kuu_chol, fp.data_Om_tril, fp.data_Kuu_inv),
        generator=generator,
    )
    F_latent_t = F_obs_t = None
    if G_test is not None:
        F_latent_t, F_obs_t = impute_at(
            spec, hp, data_aux, G_test, S, generator=generator, noise=test_noise
        )
    return ForwardResult(
        G_means, G_samples, F_latent, F_obs, warp_aux, data_aux, F_latent_t, F_obs_t
    )


def gaussian_loglik_sum(y, f, scale, mask) -> torch.Tensor:
    """Masked sum of Normal(f, scale).log_prob(y); f is (S, ...), y (...)."""
    log_prob = -0.5 * torch.square((y[None] - f) / scale) - torch.log(scale) - 0.5 * _LOG_2PI
    return torch.sum(log_prob * mask[None, ..., None])


def _expected_loglik_sum(y, mu, var, scale, mask) -> torch.Tensor:
    """Masked sum of E_q[log Normal(y; f, scale)] for f ~ N(mu, var) (mu and
    var (S, ...), y (...)): log N(y; mu, scale) - var / (2 scale^2)."""
    lp = (
        -0.5 * torch.square((y[None] - mu) / scale)
        - 0.5 * var / torch.square(scale)
        - torch.log(scale)
        - 0.5 * _LOG_2PI
    )
    return torch.sum(lp * mask[None, ..., None])


def kl_divergence(spec: ModelSpec, hp: dict, warp_aux: WarpAux, data_aux: DataAux) -> torch.Tensor:
    """Total KL over the warp and data variational posteriors.

    One ``kl_mvn_chol`` call per matrix size (per modality's data terms
    under ``merged_factor_dispatch=False``); fixed views have no lanes.
    Whitened mode: KL(q(w) || N(0, I)) per channel (``kl_whitened``), with
    no Kuu term, the same value as the square mode's for the same q."""
    KL = torch.zeros((), dtype=hp["delta_G"].dtype, device=hp["delta_G"].device)
    for _, part in kl_parts(spec, hp, warp_aux, data_aux):
        KL = KL + part
    return KL


def kl_parts(spec: ModelSpec, hp: dict, warp_aux: WarpAux, data_aux: DataAux) -> list:
    """The KL's terms in the order :func:`kl_divergence` adds them, as
    [(modality name or None, 0-d tensor)]: a term that holds one modality's
    data-layer KL alone (whitened mode, or ``merged_factor_dispatch=False``)
    is named by it; the others (the warp terms, merged groups) by None."""
    mu_q = hp["delta_G"].transpose(-1, -2)  # (V, D, m)
    V, D, m_X = mu_q.shape
    active = _active_views(spec)
    Va = len(active)
    if spec.whitened_variational:
        parts = []
        if Va:
            tk = lambda a: _take_active(spec, a, active)
            parts.append((None, kl_whitened(tk(mu_q), tk(warp_aux.Omega_tril)).sum()))
        for mod in spec.modalities:
            parts.append((mod.name, kl_whitened(
                hp["delta_F"][mod.name].transpose(-1, -2), data_aux.Omega_tril[mod.name]
            ).sum()))
        return parts
    mu_p_w = warp_aux.mu_z.transpose(-1, -2)  # (V, D, m)
    merged = spec.merged_factor_dispatch
    use_inv = (
        _wants_kuu_inverse(spec)
        and data_aux.Kuu_inv is not None
        and (Va == 0 or warp_aux.Kuu_inv is not None)
    )
    groups: Dict[int, list] = {}
    if Va:
        tk = lambda a: _take_active(spec, a, active)
        groups[m_X if merged else "warp"] = [
            (
                tk(mu_q).reshape(Va * D, m_X),
                tk(warp_aux.Omega_tril).reshape(Va * D, m_X, m_X),
                tk(mu_p_w).reshape(Va * D, m_X),
                tk(warp_aux.Kuu_chol)[:, None].expand(Va, D, m_X, m_X).reshape(Va * D, m_X, m_X),
                tk(warp_aux.Kuu_inv)[:, None].expand(Va, D, m_X, m_X).reshape(Va * D, m_X, m_X)
                if use_inv
                else None,
            )
        ]
    m_G = spec.m_G
    for mod in spec.modalities:
        delta = hp["delta_F"][mod.name]  # (m_G, L)
        L = delta.shape[-1]
        # Unmerged: each modality's terms in a call of their own.
        groups.setdefault(m_G if merged else ("data", mod.name), []).append(
            (
                delta.transpose(-1, -2),
                data_aux.Omega_tril[mod.name],
                torch.zeros(L, m_G, dtype=delta.dtype, device=delta.device),
                data_aux.Kuu_chol.expand(L, m_G, m_G),
                data_aux.Kuu_inv.expand(L, m_G, m_G) if use_inv else None,
            )
        )
    parts = []
    for key, entries in groups.items():
        cat = lambda i: torch.cat([e[i] for e in entries], dim=0)
        parts.append((key[1] if isinstance(key, tuple) else None, kl_mvn_chol(
            cat(0), cat(1), cat(2), cat(3),
            chol_p_inv=cat(4) if use_inv else None, impl=spec.cholesky_impl,
        ).sum()))
    return parts


def elbo_parts(
    spec: ModelSpec,
    hp: dict,
    batch,
    S: int,
    temperature: Temperature = 1.0,
    *,
    generator: Optional[torch.Generator] = None,
    warp_noise: Optional[torch.Tensor] = None,
    data_noise: Optional[Dict[str, torch.Tensor]] = None,
    reduce_obs: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
):
    """The ELBO's terms: ([(modality name, expected log-likelihood)],
    :func:`kl_parts`), each a 0-d tensor, in the order :func:`negative_elbo`
    adds them.

    With ``spec.analytic_data_likelihood`` the data-layer expectation is in
    closed form and only the warp layer is sampled (``data_noise`` unused).
    ``reduce_obs(name, t)`` maps each modality's observed samples (or, in
    closed form, their mean and variance) before the likelihood: the
    distributed step sums a model-sharded LMC modality's over its ranks.
    """
    if not spec.analytic_data_likelihood:
        result = forward(
            spec, hp, batch, S, temperature, generator=generator,
            warp_noise=warp_noise, data_noise=data_noise,
        )
        warp_aux, data_aux = result.warp_aux, result.data_aux
        obs = {n: (f,) for n, f in result.F_observed_samples.items()}
    else:
        X_all, _ = _concat_modalities(spec, batch)
        fp = compute_factors(spec, hp)
        _, G_sample_all, warp_aux = warp_layer(
            spec, hp, X_all, S, temperature, noise=warp_noise,
            factors=(fp.warp_Kuu_chol, fp.warp_Om_tril, fp.warp_Kuu_inv),
            generator=generator,
        )
        G_samples = _split_modalities(spec, G_sample_all, axis=2)
        mu_obs, var_obs, data_aux = data_layer_moments(
            spec, hp, G_samples, factors=(fp.data_Kuu_chol, fp.data_Om_tril, fp.data_Kuu_inv)
        )
        obs = {n: (mu_obs[n], var_obs[n]) for n in mu_obs}
    kl = kl_parts(spec, hp, warp_aux, data_aux)
    if reduce_obs is not None:
        obs = {n: tuple(reduce_obs(n, t) for t in ts) for n, ts in obs.items()}
    # Reference quirk kept: exp(noise_variance) + offset is the Normal scale.
    noise_pos = torch.exp(hp["noise_variance"]) + spec.diagonal_offset
    loglik = _expected_loglik_sum if spec.analytic_data_likelihood else gaussian_loglik_sum
    ll = []
    for mm, mod in enumerate(spec.modalities):
        scale = noise_pos[-spec.n_modalities + mm]
        b = batch[mod.name]
        ll.append((mod.name, loglik(b["outputs"], *obs[mod.name], scale, b["mask"]) / S))
    return ll, kl


def negative_elbo(
    spec: ModelSpec,
    params: dict,
    consts: dict,
    batch,
    S: int,
    temperature: Temperature = 1.0,
    *,
    generator: Optional[torch.Generator] = None,
    warp_noise: Optional[torch.Tensor] = None,
    data_noise: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """The training loss: -E[log p(y|f)] + KL, the sum of
    :func:`elbo_parts`."""
    hp = dict(consts)
    hp.update(params)
    ll, kl = elbo_parts(spec, hp, batch, S, temperature, generator=generator,
                        warp_noise=warp_noise, data_noise=data_noise)
    KL = torch.zeros((), dtype=hp["delta_G"].dtype, device=hp["delta_G"].device)
    for _, part in kl:
        KL = KL + part
    LL = torch.zeros((), dtype=KL.dtype, device=KL.device)
    for _, part in ll:
        LL = LL + part
    return -LL + KL


# ---------------------------------------------------------------------------
# Minibatch SVI
# ---------------------------------------------------------------------------


def minibatch_spec(spec: ModelSpec, batch_size: int) -> ModelSpec:
    """The spec of a ``batch_size``-points-per-view minibatch: every
    modality's point axis becomes exactly ``batch_size``."""
    if batch_size < 1:
        raise ValueError(f"minibatch size must be >= 1, got {batch_size}")
    new_mods = tuple(
        dataclasses.replace(
            m, n_padded=int(batch_size), n_samples=(int(batch_size),) * spec.n_views
        )
        for m in spec.modalities
    )
    return spec.replace(modalities=new_mods)


def importance_weights(spec: ModelSpec, sub_spec: ModelSpec, batch) -> Dict[str, torch.Tensor]:
    """{mod: (V, B) mask of N_v / B} on the batch's device: the minibatch
    masks, which depend on the data's shape only. A training loop builds
    them once and passes them to every step."""
    out = {}
    for mod, smod in zip(spec.modalities, sub_spec.modalities):
        B = smod.n_padded
        w = torch.tensor(mod.n_samples, dtype=torch.float32,
                         device=batch[mod.name]["coords"].device) / B
        out[mod.name] = w[:, None].expand(spec.n_views, B)
    return out


def subsample_batch(
    spec: ModelSpec,
    sub_spec: ModelSpec,
    batch,
    generator: Optional[torch.Generator] = None,
    indices: Optional[Dict[str, torch.Tensor]] = None,
    weights: Optional[Dict[str, torch.Tensor]] = None,
):
    """Uniform-with-replacement point subsample per view per modality.

    The masks carry ``N_v / B`` importance weights, so the masked likelihood
    sum over the sub-batch is an unbiased estimator of the full-data one
    (Hensman et al. 2013; the KL terms are data-independent). Indices are
    drawn on the device in [0, N_v) for each view, from ``generator``, so
    only real points are sampled and the step has no host sync; ``indices``
    ({mod: (V, B) int64}) replaces the draw (the tests pass the JAX
    package's). ``weights`` are the masks of :func:`importance_weights`,
    built here when not given.
    """
    if weights is None:
        weights = importance_weights(spec, sub_spec, batch)
    sub = {}
    for mod, smod in zip(spec.modalities, sub_spec.modalities):
        B = smod.n_padded
        b = batch[mod.name]
        dev = b["coords"].device
        if indices is not None:
            idx = indices[mod.name].to(dev)
        else:
            idx = torch.stack([
                torch.randint(n_v, (B,), generator=generator, device=dev) for n_v in mod.n_samples
            ])
        sub[mod.name] = {
            "coords": torch.take_along_dim(b["coords"], idx[..., None], dim=1),
            "outputs": torch.take_along_dim(b["outputs"], idx[..., None], dim=1),
            "mask": weights[mod.name],
        }
    return sub


def negative_elbo_minibatch(
    spec: ModelSpec,
    sub_spec: ModelSpec,
    params: dict,
    consts: dict,
    batch,
    S: int,
    temperature: Temperature = 1.0,
    *,
    generator: Optional[torch.Generator] = None,
    indices: Optional[Dict[str, torch.Tensor]] = None,
    warp_noise: Optional[torch.Tensor] = None,
    data_noise: Optional[Dict[str, torch.Tensor]] = None,
    weights: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Unbiased minibatch estimate of the negative ELBO: a fresh subsample
    (:func:`subsample_batch`, indices drawn first) through
    :func:`negative_elbo` on ``sub_spec``, the KL computed exactly."""
    sub = subsample_batch(spec, sub_spec, batch, generator=generator, indices=indices,
                          weights=weights)
    return negative_elbo(
        sub_spec, params, consts, sub, S, temperature, generator=generator,
        warp_noise=warp_noise, data_noise=data_noise,
    )


def draw_restart_noise(
    spec: ModelSpec,
    R: int,
    S: int,
    generator: Optional[torch.Generator],
    device: torch.device,
    sub_spec: Optional[ModelSpec] = None,
):
    """One step's draws for ``R`` restarts at once, in the order one
    restart's step draws them (the minibatch indices, then the warp noise,
    then the data noise by modality), each with a leading restart axis:
    (warp_noise (R, S, V, Ntot, D), data_noise {mod: (R, S, V*Np, L)} or
    None under ``analytic_data_likelihood``, indices {mod: (R, V, B)} or
    None). ``sub_spec`` is the minibatch's spec (:func:`minibatch_spec`);
    None draws for the full batch."""
    shape = sub_spec if sub_spec is not None else spec
    indices = None
    if sub_spec is not None:
        indices = {
            mod.name: torch.stack(
                [torch.randint(n_v, (R, smod.n_padded), generator=generator, device=device)
                 for n_v in mod.n_samples], dim=1)
            for mod, smod in zip(spec.modalities, sub_spec.modalities)
        }
    Ntot = sum(m.n_padded for m in shape.modalities)
    warp = torch.randn((R, S, shape.n_views, Ntot, shape.n_spatial_dims),
                       generator=generator, device=device)
    data = None
    if not shape.analytic_data_likelihood:
        data = {
            mod.name: torch.randn((R, S, shape.n_views * mod.n_padded, mod.n_latent),
                                  generator=generator, device=device)
            for mod in shape.modalities
        }
    return warp, data, indices


def predict_mean(spec: ModelSpec, hp: dict, batch):
    """Deterministic posterior prediction at the batch's coordinates.

    Returns ({mod: G_mean (V, Np, D)}, {mod: F_mean (V, Np, P)},
    {mod: F_var (V, Np, P)}), with no Monte-Carlo anywhere.
    """
    X_all, _ = _concat_modalities(spec, batch)
    fp = compute_factors(spec, hp)
    zero_noise = torch.zeros((1,) + tuple(X_all.shape), dtype=X_all.dtype, device=X_all.device)
    G_mean_all, _, _ = warp_layer(
        spec, hp, X_all, 1, 0.0, noise=zero_noise,
        factors=(fp.warp_Kuu_chol, fp.warp_Om_tril, fp.warp_Kuu_inv),
    )
    G_means = _split_modalities(spec, G_mean_all, axis=1)
    mu_obs, var_obs, _ = data_layer_moments(
        spec, hp, {m: G_means[m][None] for m in spec.modality_names},
        factors=(fp.data_Kuu_chol, fp.data_Om_tril, fp.data_Kuu_inv),
    )
    return (
        G_means,
        {m: mu_obs[m][0] for m in spec.modality_names},
        {m: var_obs[m][0] for m in spec.modality_names},
    )


def mean_penalty(spec: ModelSpec, hp: dict) -> torch.Tensor:
    """``mean_penalty_param`` times the mean square distance of the mean
    slopes from the identity (the reference defines it and never adds it
    to the loss; kept for its API, as the JAX package keeps it)."""
    slopes = hp["mean_slopes"]
    eye = torch.eye(spec.n_spatial_dims, dtype=slopes.dtype, device=slopes.device)
    return spec.mean_penalty_param * torch.mean(torch.square(slopes - eye))
