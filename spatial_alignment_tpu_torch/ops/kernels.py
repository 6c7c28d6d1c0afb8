"""Stationary covariance functions, in PyTorch.

Counterpart of ``spatial_alignment_tpu/ops/kernels.py``:
  - log-space (unconstrained) lengthscale / output-variance parameters,
  - ``diag=True`` returns only k(x_i, x_i'),
  - matern12 keeps the reference's ``exp(-0.5 d / l)`` form (with its
    non-standard 0.5 factor), matern32 ``(1 + sqrt(3) d / l) exp(-sqrt(3) d / l)``.

Cross-Gram matrices use the expansion ``|x - z|^2 = |x|^2 + |z|^2 - 2 x.z``,
so the O(N*M*D) work is one matrix product and no (N, M, D) difference
tensor is built.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "rbf_kernel",
    "matern12_kernel",
    "matern32_kernel",
    "rbf_kernel_numpy",
    "get_kernel",
    "kernel_name",
    "pairwise_sqdist",
]

_DIST_EPS = 1e-10  # eps under the sqrt of the matern distances
_SQRT3 = math.sqrt(3.0)


def pairwise_sqdist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared distances between rows of x1 (..., N, D) and x2 (..., M, D).

    Tiny negatives from cancellation are clamped to zero with
    ``torch.maximum``, whose gradient at a tie is split like ``jnp.maximum``'s.
    """
    n1 = torch.sum(x1 * x1, dim=-1)
    n2 = torch.sum(x2 * x2, dim=-1)
    cross = x1 @ x2.transpose(-1, -2)
    sq = n1[..., :, None] + n2[..., None, :] - 2.0 * cross
    return torch.maximum(sq, torch.zeros((), dtype=sq.dtype, device=sq.device))


def _exp(p, like: torch.Tensor) -> torch.Tensor:
    """exp of a kernel parameter given as a tensor or a Python number."""
    return torch.exp(torch.as_tensor(p, dtype=like.dtype, device=like.device))


def _sq(x1, x2, diag):
    if diag:
        return torch.sum(torch.square(x1 - x2), dim=-1)
    return pairwise_sqdist(x1, x2)


def rbf_kernel(x1, x2, lengthscale_unconstrained, output_variance_unconstrained, diag=False):
    """k(x, z) = exp(v) * exp(-0.5 * |x - z|^2 / exp(l)^2)."""
    lengthscale = _exp(lengthscale_unconstrained, x1)
    output_variance = _exp(output_variance_unconstrained, x1)
    return output_variance * torch.exp(-0.5 * _sq(x1, x2, diag) / torch.square(lengthscale))


def matern12_kernel(x1, x2, lengthscale_unconstrained, output_variance_unconstrained, diag=False):
    """Matern-1/2 in the reference's form exp(-0.5 d / l)."""
    lengthscale = _exp(lengthscale_unconstrained, x1)
    output_variance = _exp(output_variance_unconstrained, x1)
    dists = torch.sqrt(_sq(x1, x2, diag) + _DIST_EPS)
    return output_variance * torch.exp(-0.5 * dists / lengthscale)


def matern32_kernel(x1, x2, lengthscale_unconstrained, output_variance_unconstrained, diag=False):
    """Matern-3/2: (1 + sqrt(3) d / l) exp(-sqrt(3) d / l)."""
    lengthscale = _exp(lengthscale_unconstrained, x1)
    output_variance = _exp(output_variance_unconstrained, x1)
    dists = torch.sqrt(_sq(x1, x2, diag) + _DIST_EPS)
    inner = _SQRT3 * dists / lengthscale
    return output_variance * (1.0 + inner) * torch.exp(-inner)


def rbf_kernel_numpy(x, xp, kernel_params):
    """Numpy RBF used by the data generators.

    kernel_params = [log output_scale, log lengthscale...].
    """
    output_scale = np.exp(kernel_params[0])
    lengthscales = np.exp(kernel_params[1:])
    diffs = np.expand_dims(x / lengthscales, 1) - np.expand_dims(xp / lengthscales, 0)
    return output_scale * np.exp(-0.5 * np.sum(diffs**2, axis=2))


_KERNELS = {
    "rbf": rbf_kernel,
    "matern12": matern12_kernel,
    "matern32": matern32_kernel,
}


def get_kernel(kernel):
    """Resolve a kernel by name or pass a callable through."""
    if callable(kernel):
        return kernel
    try:
        return _KERNELS[kernel]
    except KeyError:
        raise ValueError(
            f"Unknown kernel {kernel!r}; expected one of {sorted(_KERNELS)} or a callable"
        ) from None


def kernel_name(kernel) -> str:
    """Inverse of get_kernel for the spec; validates names eagerly."""
    if isinstance(kernel, str):
        get_kernel(kernel)  # raises ValueError on unknown names
        return kernel
    for name, fn in _KERNELS.items():
        if fn is kernel:
            return name
    raise ValueError(
        f"Unknown kernel callable {kernel!r}; use one of {sorted(_KERNELS)}"
    )
