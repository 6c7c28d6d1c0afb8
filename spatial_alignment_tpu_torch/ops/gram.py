"""Differentiable cross-Gram K[..., i, j] = k(x1[..., i], x2[..., j]): the
hand-written CUDA kernel, its plain version, and the dispatch between them
and the expansion form.

Counterpart of ``spatial_alignment_tpu/ops/pallas_gram.py``. The kernel
(``csrc/gram.cu``, design and bound in its header) replaces ``pallas_gram``.
As in the JAX package, ``gram`` takes it only when forced: by its ``force``
argument, else by the process-wide switch :func:`set_gram_force`, which is
read at call time (the port runs eagerly, so there is no trace to set it
before). Without force the forward is the expansion form of
:mod:`.kernels` on either device, the counterpart of JAX's XLA path. Under
force a CUDA tensor launches the kernel or raises, and a CPU tensor takes
:func:`gram_plain`; nothing falls back from one route to another.

The backward is always the closed form of ``_gram_vjp_bwd``, in
matrix-product form: neither pass builds an (..., m, N, D) difference
tensor, which autograd through the broadcast formulation would.

Batching: x1 (..., m, D) and x2 (..., N, D) broadcast over their leading
dims. A kernel parameter is either one value (any shape with one element)
or one value per leading batch entry (shape = the batch shape), which is how
the warp layer passes its per-view lengthscales and variances. Gradients
are summed back over every dim an input was broadcast along.

Counters: ``launches`` counts kernel launches, ``plain_calls`` calls of
:func:`gram_plain`. Set either to 0 before a run and read it after.
A captured training step counts once, at its capture; the training
loop (``models/train.py``) adds that step's counts once per replay.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .kernels import get_kernel, pairwise_sqdist

__all__ = ["gram", "gram_kernel", "gram_plain", "set_gram_force"]

COUNTERS = ("launches", "plain_calls")
launches = 0
plain_calls = 0

_SQRT3 = math.sqrt(3.0)
_KINDS = {"rbf": 0, "matern12": 1, "matern32": 2}
_MAX_DIM = 8  # the TPU kernel's one padded sublane tile of coordinates
_DIST_EPS = 1e-10

# Process-wide dispatch override (None: the expansion form).
_FORCE: Optional[bool] = None

_lib = None


def set_gram_force(force: Optional[bool]) -> None:
    """Send every ``gram`` without an explicit ``force`` to the kernel
    (True), to the expansion form (False), or back to the default (None)."""
    global _FORCE
    _FORCE = force


def gram_force() -> Optional[bool]:
    """The switch :func:`set_gram_force` set (read when a step is captured)."""
    return _FORCE


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("gram")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sat_gram_f32.argtypes = [vp, ll, vp, ll, vp, i, vp, i, vp, i, i, i, i, i, i, vp]
        lib.sat_gram_f32.restype = i
        lib.sat_gram_row_splits.argtypes = [i, i, i]
        lib.sat_gram_row_splits.restype = ll
        lib.sat_empty_kernel.argtypes = [vp]
        lib.sat_empty_kernel.restype = i
        _lib = lib
    return _lib


def _param(p: torch.Tensor) -> torch.Tensor:
    """A kernel parameter shaped to broadcast against (..., m, N)."""
    if p.numel() == 1:
        return p.reshape(())
    return p.reshape(p.shape + (1, 1))


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; expected one of {sorted(_KINDS)}")


def gram_plain(x1, x2, log_ls, log_var, kind: str = "rbf", out_dtype=torch.float32):
    """Plain version of :func:`gram_kernel`: direct differences summed over
    the coordinates in order, then the kernel's arithmetic in the kernel's
    order (``_gram_kernel_body``), in float32; ``out_dtype`` only rounds
    the result."""
    global plain_calls
    _check_kind(kind)
    plain_calls += 1
    D = x1.shape[-1]
    acc = torch.zeros(
        torch.broadcast_shapes(x1.shape[:-1] + (1,), x2.shape[:-2] + (1, x2.shape[-2])),
        dtype=x1.dtype, device=x1.device,
    )
    for d in range(D):
        diff = x1[..., :, d, None] - x2[..., None, :, d]
        acc = acc + diff * diff
    log_ls, log_var = _param(log_ls), _param(log_var)
    var = torch.exp(log_var)
    if kind == "rbf":
        out = var * torch.exp(-0.5 * acc * torch.exp(-2.0 * log_ls))
    elif kind == "matern12":
        dist = torch.sqrt(acc + _DIST_EPS)
        out = var * torch.exp(-0.5 * dist * torch.exp(-log_ls))
    else:
        dist = torch.sqrt(acc + _DIST_EPS)
        inner = _SQRT3 * dist * torch.exp(-log_ls)
        out = var * (1.0 + inner) * torch.exp(-inner)
    return out.to(out_dtype)


def _groups(t: torch.Tensor, lead, G: int, rows: int):
    """(contiguous (G or 1, rows, D) tensor, elements per group: 0 when every
    group shares it)."""
    if math.prod(t.shape[:-2]) == 1:
        return t.reshape(rows, t.shape[-1]).contiguous(), 0
    t = t.expand(tuple(lead) + tuple(t.shape[-2:])).reshape(G, rows, t.shape[-1])
    return t.contiguous(), rows * t.shape[-1]


def _group_param(p: torch.Tensor, lead, G: int):
    if p.numel() == 1:
        return p.reshape(1).contiguous(), 0
    return p.expand(tuple(lead)).reshape(G).contiguous(), 1


def gram_kernel(x1, x2, log_ls, log_var, kind: str = "rbf", out_dtype=torch.float32):
    """Launch the CUDA kernel on float32 CUDA tensors; returns
    (..., M, N) in ``out_dtype`` (float32 or bfloat16) with the broadcast
    leading dims of x1, x2 and the parameters."""
    global launches
    _check_kind(kind)
    if x1.dim() < 2 or x2.dim() < 2 or x1.shape[-1] != x2.shape[-1]:
        raise ValueError(f"gram_kernel: x1 {tuple(x1.shape)} and x2 {tuple(x2.shape)} do not fit")
    M, D = x1.shape[-2:]
    N = x2.shape[-2]
    if D > _MAX_DIM:
        raise ValueError(f"gram_kernel takes at most {_MAX_DIM} coordinates, got {D}")
    for t in (x1, x2, log_ls, log_var):
        if t.device.type != "cuda":
            raise ValueError(f"gram_kernel needs CUDA tensors, got {t.device}")
        if t.device != x1.device:
            raise ValueError(f"gram_kernel: tensors on {x1.device} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gram_kernel takes float32, got {t.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gram_kernel stores float32 or bfloat16, not {out_dtype}")
    lead = torch.broadcast_shapes(
        x1.shape[:-2], x2.shape[:-2], *(p.shape for p in (log_ls, log_var) if p.numel() != 1)
    )
    G = math.prod(lead)
    out = torch.empty(tuple(lead) + (M, N), dtype=out_dtype, device=x1.device)
    if out.numel() == 0:
        return out
    a, a_stride = _groups(x1, lead, G, M)
    b, b_stride = _groups(x2, lead, G, N)
    ls, ls_stride = _group_param(log_ls, lead, G)
    lv, lv_stride = _group_param(log_var, lead, G)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = _library().sat_gram_f32(
            a.data_ptr(), a_stride, b.data_ptr(), b_stride, ls.data_ptr(), ls_stride,
            lv.data_ptr(), lv_stride, out.data_ptr(), int(out_dtype == torch.bfloat16),
            G, M, N, D, _KINDS[kind], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"gram kernel launch failed with CUDA error {err} (G={G}, M={M}, N={N}, D={D})"
        )
    launches += 1
    return out


def design(G: int, M: int, N: int) -> dict:
    """How the kernel cuts a (G, M, N) Gram on the current device
    (``csrc/gram.cu``): the ranges its M rows are cut into."""
    splits = _library().sat_gram_row_splits(G, M, N)
    if splits < 0:
        raise RuntimeError(f"gram design query failed with CUDA error {-splits}")
    return {"row_splits": int(splits)}


def _forward(x1, x2, log_ls, log_var, kind, force):
    use_kernel = force if force is not None else bool(_FORCE)
    if not use_kernel:
        return get_kernel(kind)(x1, x2, _param(log_ls), _param(log_var))
    if x1.device.type == "cpu":
        return gram_plain(x1, x2, log_ls, log_var, kind)
    return gram_kernel(x1, x2, log_ls, log_var, kind)


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
    def forward(x1, x2, log_ls, log_var, kind, force):
        return _forward(x1, x2, log_ls, log_var, kind, force)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x1, x2, log_ls, log_var, ctx.kind, _ = inputs
        ctx.save_for_backward(x1, x2, log_ls, log_var, output)

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
            d = torch.sqrt(sq + _DIST_EPS)
            W = g * K
            coef = 0.5 * W / (ls * d)
            g_ll_full = W * 0.5 * d / ls
        elif kind == "matern32":
            d = torch.sqrt(sq + _DIST_EPS)
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
            None,
        )

    @staticmethod
    def vmap(info, in_dims, x1, x2, log_ls, log_var, kind, force):
        # The vmapped dim becomes the first leading batch dim of the Gram:
        # each batched input gets it in front of its own leading dims, padded
        # with 1s to the rank k of their broadcast; a batched parameter of
        # one value a restart becomes one value per leading batch entry.
        # Unbatched inputs broadcast from the right as they are.
        R = info.batch_size
        inputs = (x1, x2, log_ls, log_var)
        front = [None if d is None else a.movedim(d, 0) for a, d in zip(inputs, in_dims)]
        # Each input's shape within one restart, and its leading batch dims.
        own = [tuple(a.shape if f is None else f.shape[1:]) for a, f in zip(inputs, front)]
        lead = [own[0][:-2], own[1][:-2]] + [() if math.prod(p) == 1 else p for p in own[2:]]
        k = max(len(b) for b in lead)
        tails = [own[0][-2:], own[1][-2:], (), ()]
        args = [a if f is None else f.reshape((R,) + (1,) * (k - len(b)) + b + t)
                for a, f, b, t in zip(inputs, front, lead, tails)]
        return _Gram.apply(*args, kind, force), 0


def gram(x1, x2, log_ls, log_var, kind: str = "rbf", force: Optional[bool] = None):
    """Cross-Gram with the closed-form backward. ``force`` True takes the
    kernel (or, for CPU tensors, its plain version), False the expansion
    form; None defers to :func:`set_gram_force` (see the module docstring)."""
    return _Gram.apply(x1, x2, log_ls, log_var, kind, force)
