"""Differentiable cross-Gram K[..., i, j] = k(x1[..., i], x2[..., j]).

Counterpart of ``spatial_alignment_tpu/ops/pallas_gram.py:gram``. The JAX
package's default dispatch never takes its Pallas Gram kernel, so the
forward here is the plain expansion-form kernel of :mod:`.kernels`. The
backward is the closed form of ``_gram_vjp_bwd``, in matrix-product form:
neither pass builds an (..., m, N, D) difference tensor, which autograd
through the broadcast formulation would.

Batching: x1 (..., m, D) and x2 (..., N, D) broadcast over their leading
dims. A kernel parameter is either one value (any shape with one element)
or one value per leading batch entry (shape = the batch shape), which is how
the warp layer passes its per-view lengthscales and variances. Gradients
are summed back over every dim an input was broadcast along.
"""

from __future__ import annotations

import math

import torch

from .kernels import get_kernel, pairwise_sqdist

__all__ = ["gram"]

_SQRT3 = math.sqrt(3.0)


def _param(p: torch.Tensor) -> torch.Tensor:
    """A kernel parameter shaped to broadcast against (..., m, N)."""
    if p.numel() == 1:
        return p.reshape(())
    return p.reshape(p.shape + (1, 1))


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """Sum ``t`` down to ``shape`` over the dims it was broadcast along."""
    shape = tuple(shape)
    lead = t.dim() - len(shape)
    if lead > 0:
        t = t.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and t.shape[i] != 1)
    if dims:
        t = t.sum(dim=dims, keepdim=True)
    return t


def _param_grad(full: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Reduce a per-entry (..., m, N) parameter cotangent to ``p``'s shape."""
    if p.numel() == 1:
        return full.sum().reshape(p.shape)
    return _sum_to(full.sum(dim=(-2, -1)), p.shape)


class _Gram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, log_ls, log_var, kind):
        K = get_kernel(kind)(x1, x2, _param(log_ls), _param(log_var))
        ctx.kind = kind
        ctx.save_for_backward(x1, x2, log_ls, log_var, K)
        return K

    @staticmethod
    def backward(ctx, g):
        x1, x2, log_ls, log_var, K = ctx.saved_tensors
        kind = ctx.kind
        ls = torch.exp(_param(log_ls))
        sq = pairwise_sqdist(x1, x2)  # (..., m, N)

        if kind == "rbf":
            W = g * K
            coef = W / torch.square(ls)  # per-pair weight on (x1_i - x2_j)
            g_ll_full = W * sq / torch.square(ls)
        elif kind == "matern12":
            d = torch.sqrt(sq + 1e-10)
            W = g * K
            coef = 0.5 * W / (ls * d)
            g_ll_full = W * 0.5 * d / ls
        elif kind == "matern32":
            d = torch.sqrt(sq + 1e-10)
            a = _SQRT3 * d / ls
            v = torch.exp(_param(log_var))
            W = g * (-v * a * torch.exp(-a))  # g * dK/da
            coef = -W * _SQRT3 / (ls * d)
            g_ll_full = -W * a
        else:
            raise ValueError(f"unknown kernel kind {kind!r}")

        # g_x1[i] = -sum_j coef_ij (x1_i - x2_j);  g_x2[j] = +sum_i coef_ij (...)
        row = coef.sum(dim=-1)  # (..., m)
        col = coef.sum(dim=-2)  # (..., N)
        cx2 = coef @ x2  # (..., m, D)
        cx1 = coef.transpose(-1, -2) @ x1  # (..., N, D)
        g_x1 = -(row[..., :, None] * x1 - cx2)
        g_x2 = -(col[..., :, None] * x2 - cx1)
        return (
            _sum_to(g_x1, x1.shape),
            _sum_to(g_x2, x2.shape),
            _param_grad(g_ll_full, log_ls),
            _param_grad(g * K, log_var),  # every kernel is linear in exp(log_var)
            None,
        )


def gram(x1, x2, log_ls, log_var, kind: str = "rbf") -> torch.Tensor:
    """Cross-Gram with the closed-form backward (see the module docstring)."""
    return _Gram.apply(x1, x2, log_ls, log_var, kind)
