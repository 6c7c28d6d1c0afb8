"""Numerically hardened linear algebra for the SVGP layers, in PyTorch.

Counterpart of ``spatial_alignment_tpu/ops/linalg.py`` on its default path:
jittered Cholesky with NaN-probe escalation, the merged factor slabs,
triangular and Cholesky solves, and Gaussian KLs. Every factorization goes
through :func:`.cholesky.cholesky`, so a CUDA tensor always runs the
hand-written kernel. Triangular solves and inverses are
``torch.linalg.solve_triangular``, as the JAX default leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .cholesky import cholesky

__all__ = [
    "add_jitter",
    "jittered_cholesky",
    "jittered_cholesky_inverse",
    "joint_factor_cholesky",
    "joint_factor_cholesky_inverse",
    "factor_psd_cholesky",
    "tri_solve",
    "tri_inverse",
    "cholesky_solve",
    "chol_logdet",
    "kl_mvn_chol",
    "kl_whitened",
]

# f32 unit roundoff: storing an exactly-PSD kernel Gram in f32 perturbs its
# eigenvalues by about sqrt(m) * ulp * |K|_2.
_ULP_F32 = 1.2e-7
_NOISE_SAFETY = 0.5  # a few times above that storage-rounding floor
# The noise floor applies only from this STATIC factor size up. Small Grams
# factor at the reference-scale eps and need exactly eps for accuracy; large
# near-rank-1 Grams cannot factor at eps from storage rounding alone. The two
# regimes are disjoint in m, and gating on the static size keeps the jitter a
# continuous function of the parameters within each.
_FLOOR_MIN_M = 64


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


def _diag_mean(mat: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.diagonal(mat, dim1=-2, dim2=-1).mean(dim=-1), 1.0)


def add_jitter(mat: torch.Tensor, jitter: float) -> torch.Tensor:
    """mat + jitter * I on the trailing two dims (batched)."""
    return mat + jitter * _eye(mat.shape[-1], mat)


def _base_jitter(mat: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-matrix jitter: eps * max(1, mean diag), raised to the f32 noise
    floor 0.5 sqrt(m) ulp max_row_sum(|K|) at static m >= _FLOOR_MIN_M.
    Detached: the jitter is numerical stabilization, not a model quantity."""
    m = mat.shape[-1]
    base = eps * _diag_mean(mat)
    if m >= _FLOOR_MIN_M:
        row_norm = torch.abs(mat).sum(dim=-1).amax(dim=-1)
        base = torch.maximum(base, _NOISE_SAFETY * math.sqrt(m) * _ULP_F32 * row_norm)
    return base.detach()


def _is_ok(L: torch.Tensor) -> torch.Tensor:
    return torch.logical_not(torch.isnan(L).any(dim=-1).any(dim=-1))


def _probed_jitter(mat: torch.Tensor, eps: float) -> torch.Tensor:
    """The NaN-probe-escalated jitter of a (batched) Gram slab.

    Below the floor gate one probe escalates straight to 100x. From m >= 64
    the base and 10x rungs are stacked along a new leading axis and factored
    in one call; the rung is 1x, 10x or 100x. The choice is made on the
    device with ``torch.where`` (no host sync)."""
    base = _base_jitter(mat, eps)
    m = mat.shape[-1]
    eye = _eye(m, mat)
    frozen = mat.detach()
    if m >= _FLOOR_MIN_M:
        slab = torch.stack([base, 10.0 * base])  # (2, ...batch)
        probes = cholesky(frozen[None] + slab[..., None, None] * eye)
        ok = _is_ok(probes)
        return torch.where(ok[0], base, torch.where(ok[1], 10.0 * base, 100.0 * base))
    L = cholesky(frozen + base[..., None, None] * eye)
    return torch.where(_is_ok(L), base, 100.0 * base)


def jittered_cholesky(mat: torch.Tensor, eps: float) -> torch.Tensor:
    """Lower Cholesky of mat + jitter * I with the probed jitter."""
    jitter = _probed_jitter(mat, eps)
    return cholesky(mat + jitter[..., None, None] * _eye(mat.shape[-1], mat))


def jittered_cholesky_inverse(
    mat: torch.Tensor, eps: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`jittered_cholesky` plus the explicit factor inverse L^-1."""
    L = jittered_cholesky(mat, eps)
    return L, tri_inverse(L)


def joint_factor_cholesky_inverse(
    gram: torch.Tensor,
    psd_sqt: Optional[torch.Tensor],
    eps: float,
    *,
    n_inv: int = 0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Factor a Gram slab and a PSD-product slab in ONE final call.

    ``gram`` (Bg, m, m) gets the probed jitter; ``psd_sqt`` (Bp, m, m) holds
    free square factors A whose products A A^T + eps * max(1, mean diag) * I
    are factored without probes (PSD by construction). Returns
    (L_gram, L_psd | None, inverses of the first ``n_inv`` factors | None).
    """
    jitter = _probed_jitter(gram, eps)
    m = gram.shape[-1]
    eye = _eye(m, gram)
    jittered = gram + jitter[..., None, None] * eye
    if psd_sqt is None:
        slab = jittered
    else:
        mat = psd_sqt @ psd_sqt.transpose(-1, -2)
        scale = _diag_mean(mat).detach()
        slab = torch.cat([jittered, mat + (eps * scale)[..., None, None] * eye], dim=0)
    L = cholesky(slab)
    inv = tri_inverse(L[:n_inv]) if n_inv else None
    Bg = gram.shape[0]
    if psd_sqt is None:
        return L, None, inv
    return L[:Bg], L[Bg:], inv


def joint_factor_cholesky(
    gram: torch.Tensor, psd_sqt: Optional[torch.Tensor], eps: float
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`joint_factor_cholesky_inverse` without inverses."""
    Lg, Lp, _ = joint_factor_cholesky_inverse(gram, psd_sqt, eps)
    return Lg, Lp


def factor_psd_cholesky(sqt: torch.Tensor, eps: float) -> torch.Tensor:
    """Lower Cholesky of ``sqt @ sqt^T + eps * max(1, mean diag) * I``."""
    mat = sqt @ sqt.transpose(-1, -2)
    scale = _diag_mean(mat).detach()
    return cholesky(mat + (eps * scale)[..., None, None] * _eye(mat.shape[-1], mat))


def tri_solve(chol: torch.Tensor, rhs: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """Solve L x = rhs (L^T x = rhs when ``trans``); batch dims broadcast."""
    if trans:
        return torch.linalg.solve_triangular(chol.transpose(-1, -2), rhs, upper=True)
    return torch.linalg.solve_triangular(chol, rhs, upper=False)


def tri_inverse(chol: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a lower-triangular factor: one width-m solve
    against I, differentiated by autograd through the solve."""
    eye = _eye(chol.shape[-1], chol).expand(chol.shape)
    return torch.linalg.solve_triangular(chol, eye, upper=False)


def cholesky_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve A x = rhs given A = L L^T: L^T \\ (L \\ rhs), as cho_solve."""
    return tri_solve(chol, tri_solve(chol, rhs), trans=True)


def chol_logdet(chol: torch.Tensor) -> torch.Tensor:
    """log|A| = 2 sum log |diag L|, batched."""
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    return 2.0 * torch.log(torch.abs(diag)).sum(dim=-1)


def kl_whitened(mu_q: torch.Tensor, chol_q: torch.Tensor) -> torch.Tensor:
    """KL( N(mu_q, A A^T) || N(0, I) ) from the factor A, batched."""
    k = mu_q.shape[-1]
    trace_term = torch.square(chol_q).sum(dim=(-2, -1))
    quad = torch.square(mu_q).sum(dim=-1)
    return 0.5 * (trace_term + quad - k - chol_logdet(chol_q))


def kl_mvn_chol(
    mu_q: torch.Tensor,
    chol_q: torch.Tensor,
    mu_p: torch.Tensor,
    chol_p: torch.Tensor,
    chol_p_inv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KL( N(mu_q, Lq Lq^T) || N(mu_p, Lp Lp^T) ), batched:
    0.5 [ |Lp^-1 Lq|_F^2 + |Lp^-1 (mu_p - mu_q)|^2 - k + log|Sp| - log|Sq| ].
    Both terms share one solve (or one product with ``chol_p_inv``)."""
    k = mu_q.shape[-1]
    diff = (mu_p - mu_q)[..., :, None]
    batch = torch.broadcast_shapes(chol_q.shape[:-2], diff.shape[:-2])
    rhs = torch.cat(
        [chol_q.expand(batch + chol_q.shape[-2:]), diff.expand(batch + diff.shape[-2:])],
        dim=-1,
    )
    sol = chol_p_inv @ rhs if chol_p_inv is not None else tri_solve(chol_p, rhs)
    trace_term = torch.square(sol[..., :k]).sum(dim=(-2, -1))
    quad = torch.square(sol[..., k:]).sum(dim=(-2, -1))
    logdet = chol_logdet(chol_p) - chol_logdet(chol_q)
    return 0.5 * (trace_term + quad - k + logdet)
