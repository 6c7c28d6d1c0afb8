"""Diagonal quadratic forms of the SVGP predictive variance: the
hand-written CUDA forward and backward kernels and their plain version.

    quad_diag(xT, F)[..., b, n] = sum_k (xT[..., n, :] @ F_b)[k] ** 2

Replaces ``spatial_alignment_tpu/ops/pallas_quad.py:quad_diag`` (forward
``_fwd_pallas``, backward ``_bwd_pallas``). Like the TPU kernels, the CUDA
kernels (``csrc/quad.cu``, design and bound in its header) never write the
(..., L, N, m) product to device memory, and the backward makes it again
tile by tile instead of saving it. Both run on the tensor cores in 3xTF32;
the backward's dx and dF passes each make t and feed it, in registers, to
their second product, their chunks split over blocks whose partial sums are
added in a fixed order (:func:`bwd_design` reports the split; above m = 256
two warps share each group of rows, above m = 512 the first design runs).
``models.core`` sends a quad-diag here
only under ``quad_diag_impl="pallas"``; otherwise it runs
:func:`quad_diag_plain` and autograd, as the JAX package's ``xla`` route.

The factors take two forms, in one launch each:
  - shared, F (L, m, m), as the data layer's: xT (..., N, m);
  - one set per leading index, F (..., L, m, m) with the leading dims of
    xT (..., N, m), as the warp layer's per-view factors. JAX hides this
    axis under ``vmap``; here it is the kernel's group axis.

Dispatch is by the tensor's device alone: a CUDA tensor launches the kernels
or raises, a CPU tensor takes the plain forward and the plain backward
(the JAX package's jnp pullback, ``pallas_quad.py:408-417``). Nothing falls
back from one to the other. Everything is float32.

Counters: ``fwd_launches`` and ``bwd_launches`` count kernel launches of the
forward and of the backward (one backward call launches its two to four
kernels and counts once); ``plain_calls`` counts forward and backward calls that
took the plain version because their tensors lay on the CPU.
A captured training step counts once, at its capture; the training
loop (``models/train.py``) adds that step's counts once per replay.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from ._restart_axis import to_front

__all__ = [
    "quad_diag",
    "quad_diag_plain",
    "quad_fwd_kernel",
    "quad_bwd_kernel",
    "quad_bwd_plain",
]

COUNTERS = ("fwd_launches", "bwd_launches", "plain_calls")
fwd_launches = 0
bwd_launches = 0
plain_calls = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("quad")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sat_quad_fwd_strided_f32.argtypes = [vp, ll, ll, ll, vp, ll, vp, i, i, i, i, vp]
        lib.sat_quad_fwd_strided_f32.restype = i
        lib.sat_quad_bwd_f32.argtypes = [vp, vp, ll, vp, vp, vp, vp, i, i, i, i, i, vp]
        lib.sat_quad_bwd_f32.restype = i
        lib.sat_quad_bwd_design.argtypes = [i, i, i, i, i, ctypes.POINTER(ll)]
        lib.sat_quad_bwd_design.restype = i
        _lib = lib
    return _lib


def quad_diag_plain(xT: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """(..., L, N) from xT (..., N, m) and factors (L, m, m) or
    (..., L, m, m), materializing the product; autograd differentiates it.
    The plain version of :func:`quad_fwd_kernel`."""
    t = xT.unsqueeze(-3) @ factors  # (..., L, N, m)
    return torch.square(t).sum(dim=-1)


# The kernels' canonical form: x (G, N, m); F (L, m, m) shared or
# (G, L, m, m) per group; out and dy (G, L, N).


def _dims(x: torch.Tensor, F: torch.Tensor):
    G, N, m = x.shape
    L = F.shape[-3]
    per_group = F.dim() == 4
    return G, N, m, L, per_group


def _check(x: torch.Tensor, F: torch.Tensor, what: str):
    for t in (x, F):
        if t.device.type != "cuda":
            raise ValueError(f"{what} needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {t.dtype}")
    if F.device != x.device:
        raise ValueError(f"{what}: x on {x.device}, F on {F.device}")
    G, N, m, L, per_group = _dims(x, F)
    want = (G, L, m, m) if per_group else (L, m, m)
    if x.dim() != 3 or tuple(F.shape) != want:
        raise ValueError(f"{what}: x {tuple(x.shape)} and F {tuple(F.shape)} do not fit")


def quad_fwd_kernel(x: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on the canonical form; returns (G, L, N)."""
    global fwd_launches
    _check(x, F, "quad_fwd_kernel")
    G, N, m, L, per_group = _dims(x, F)
    out = torch.empty((G, L, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    F = F.contiguous()
    # The kernel reads x by rows or transposed (the view the model passes)
    # in place; any other layout is copied first.
    if x.stride(-1) != 1 and x.stride(-2) != 1:
        x = x.contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().sat_quad_fwd_strided_f32(
            x.data_ptr(), *x.stride(), F.data_ptr(), L * m * m if per_group else 0,
            out.data_ptr(), G, N, m, L, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"quad forward kernel launch failed with CUDA error {err} "
            f"(G={G}, N={N}, m={m}, L={L})"
        )
    fwd_launches += 1
    return out


def quad_bwd_kernel(x: torch.Tensor, F: torch.Tensor, dy: torch.Tensor):
    """Launch the backward kernels on the canonical form; returns (dx, dF)."""
    global bwd_launches
    _check(x, F, "quad_bwd_kernel")
    G, N, m, L, per_group = _dims(x, F)
    if tuple(dy.shape) != (G, L, N) or dy.dtype != torch.float32 or dy.device != x.device:
        raise ValueError(f"quad_bwd_kernel: dy {tuple(dy.shape)} {dy.dtype}, want ({G}, {L}, {N})")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dF = torch.empty(F.shape, dtype=F.dtype, device=F.device)
    if dx.numel() == 0 or dF.numel() == 0:
        return dx.zero_(), dF.zero_()
    x, F, dy = x.contiguous(), F.contiguous(), dy.contiguous()
    n_groups = G if per_group else 1
    with torch.cuda.device(x.device):
        design = bwd_design(G, N, m, L, n_groups)
        scratch = torch.empty((design["scratch_floats"],), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().sat_quad_bwd_f32(
            x.data_ptr(), F.data_ptr(), L * m * m if per_group else 0, dy.data_ptr(),
            dx.data_ptr(), dF.data_ptr(), scratch.data_ptr(), G, N, m, L, n_groups, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"quad backward kernel launch failed with CUDA error {err} "
            f"(G={G}, N={N}, m={m}, L={L}, design={design})"
        )
    bwd_launches += 1
    return dx, dF


_DESIGN_KEYS = ("column_tiles", "block_rows", "chunk", "blocks_per_sm_dx", "blocks_per_sm_df",
                "splits_dx", "splits_df", "scratch_floats", "row_group_warps", "stages_dx",
                "stages_df")


@functools.lru_cache(maxsize=None)
def _design(device_index: int, G: int, N: int, m: int, L: int, n_groups: int) -> tuple:
    out = (ctypes.c_longlong * len(_DESIGN_KEYS))()
    err = _library().sat_quad_bwd_design(G, N, m, L, n_groups, out)
    if err != 0:
        raise RuntimeError(f"quad backward design query failed with CUDA error {err}")
    return tuple(int(v) for v in out)


def bwd_design(G: int, N: int, m: int, L: int, n_groups: int) -> dict:
    """What the backward launches at these sizes on the current device
    (``csrc/quad.cu``): its column tiles (0 above m = 512, the wide
    variant), block rows, chunk depth, blocks per SM, splits of dx and of
    dF (each above 1 adds a fixed-order sum), the floats of scratch, the
    warps that share a group of 16 rows (2 above m = 256) and the chunk
    buffers of the dx and the dF kernel."""
    values = _design(torch.cuda.current_device(), G, N, m, L, n_groups)
    return dict(zip(_DESIGN_KEYS, values))


def quad_bwd_plain(x: torch.Tensor, F: torch.Tensor, dy: torch.Tensor):
    """Plain version of :func:`quad_bwd_kernel`, the JAX package's pullback:
    t = x F_b, w = 2 dy t, dx = sum_b w F_bᵀ, dF_b = sum_n xᵀ w."""
    t = x.unsqueeze(1) @ F  # (G, L, N, m)
    w = 2.0 * t * dy.unsqueeze(-1)
    dx = (w @ F.transpose(-1, -2)).sum(dim=1)
    if F.dim() == 4:
        dF = torch.einsum("gni,gbnk->gbik", x, w)
    else:
        dF = torch.einsum("gni,gbnk->bik", x, w)
    return dx, dF


def _fwd(x, F):
    global plain_calls
    if x.device.type == "cpu":
        plain_calls += 1
        return quad_diag_plain(x, F)
    return quad_fwd_kernel(x, F)


def _bwd(x, F, dy):
    global plain_calls
    if x.device.type == "cpu":
        plain_calls += 1
        return quad_bwd_plain(x, F, dy)
    return quad_bwd_kernel(x, F, dy)


class _QuadDiag(torch.autograd.Function):
    @staticmethod
    def forward(x, F):
        return _fwd(x, F)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, F = ctx.saved_tensors
        return _bwd(x, F, dy)

    @staticmethod
    def vmap(info, in_dims, x, F):
        # x (R, G, N, m) folds into (R G, N, m). F keeps the shared form only
        # when it is the same for every restart; otherwise each of the R G
        # groups gets its own copy (one launch either way).
        R = info.batch_size
        x = to_front(x, in_dims[0], R)
        G = x.shape[1]
        if in_dims[1] is not None or F.dim() == 4:
            F = to_front(F, in_dims[1], R)
            if F.dim() == 4:  # (R, L, m, m): shared within each restart
                F = F.unsqueeze(1).expand(R, G, *F.shape[1:])
            F = F.reshape((R * G,) + tuple(F.shape[2:]))
        out = _QuadDiag.apply(x.reshape((R * G,) + tuple(x.shape[2:])), F)
        return out.reshape((R, G) + tuple(out.shape[1:])), 0


def _canonical_factors(factors: torch.Tensor, lead, G: int) -> torch.Tensor:
    if factors.dim() == 3:
        return factors
    if tuple(factors.shape[:-3]) != tuple(lead):
        raise ValueError(
            f"quad_diag: factors {tuple(factors.shape)} must be (L, m, m) or carry "
            f"xT's leading dims {tuple(lead)}"
        )
    return factors.reshape((G,) + tuple(factors.shape[-3:]))


def quad_diag(xT: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Differentiable (..., L, N) quadratic-form diagonals through the
    kernels (see the module doc for the two forms of ``factors``)."""
    lead = xT.shape[:-2]
    N, m = xT.shape[-2:]
    G = math.prod(lead)
    x3 = xT.reshape(G, N, m)
    F = _canonical_factors(factors, lead, G)
    out = _QuadDiag.apply(x3, F)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))
