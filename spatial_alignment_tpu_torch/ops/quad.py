"""Diagonal quadratic forms of the SVGP predictive variance: the
hand-written CUDA forward and backward kernels and their plain version.

    quad_diag(xT, F)[..., b, n] = sum_k (xT[..., n, :] @ F_b)[k] ** 2

Replaces ``spatial_alignment_tpu/ops/pallas_quad.py:quad_diag`` (forward
``_fwd_pallas``, backward ``_bwd_pallas``). Like the TPU kernels, the CUDA
kernels (``csrc/quad.cu``, design and bound in its header) never write the
(..., L, N, m) product to device memory, and the backward makes it again
tile by tile instead of saving it. Both run on the tensor cores, and take
the precision name the TPU kernels take (``pallas_quad.py:_dot_prec``):
``high`` and ``highest`` in 3xTF32 (about 2^-21 of a product), ``default``
in one TF32 pass (operands rounded to TF32, about 2^-11 each), as the TPU
kernel runs one bf16 pass. The two modes are two builds of ``quad.cu``
(libraries ``quad`` and ``quad_tf32``). The backward's dx and dF passes
each make t and feed it, in registers, to their second product, their
chunks split over blocks whose partial sums are added in a fixed order
(:func:`bwd_design` reports the split; above m = 256 two warps share each
group of rows, above m = 512 the first design runs, in fp32 tiles). In the
one-pass build at m <= 256 with m a multiple of 4 the products run on
Hopper's warpgroup MMA (``wgmma``) instead of ``mma.sync``, fed by bulk
copies through a ring of shared-memory slices; a first launch makes
rounded, pre-tiled copies of F (and, for the backward, of x, which it
reads at its strides: no contiguous copy is taken), and the backward runs
its dF pass before its dx pass.
``models.core`` sends a quad-diag here
only under ``quad_diag_impl="pallas"``; otherwise it runs
:func:`quad_diag_plain` and autograd, as the JAX package's ``xla`` route.
The plain versions form their products through :mod:`.precision`: at
``default`` on a CUDA tensor in cuBLAS TF32, in both directions.

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
forward and of the backward (one backward call launches its two to five
kernels and counts once); ``wgmma_launches`` counts the forward and
backward calls that took the warpgroup-MMA design; ``plain_calls`` counts
forward and backward calls that took the plain version because their
tensors lay on the CPU.
A captured training step counts once, at its capture; the training
loop (``models/train.py``) adds that step's counts once per replay.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from . import precision as _precision
from ._restart_axis import to_front

__all__ = [
    "quad_diag",
    "quad_diag_plain",
    "quad_fwd_kernel",
    "quad_bwd_kernel",
    "quad_bwd_plain",
]

COUNTERS = ("fwd_launches", "bwd_launches", "wgmma_launches", "plain_calls")
fwd_launches = 0
bwd_launches = 0
wgmma_launches = 0
plain_calls = 0

_libs = {}


def _library(precision: str = "highest") -> ctypes.CDLL:
    """The build of ``csrc/quad.cu`` that runs ``precision``: ``quad_tf32``
    (one TF32 pass) for ``default``, ``quad`` (3xTF32) otherwise."""
    name = "quad_tf32" if _precision.check_name(precision) == "default" else "quad"
    if name not in _libs:
        lib = _build.load(name)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sat_quad_fwd_strided_f32.argtypes = [vp, ll, ll, ll, vp, ll, vp, vp, i, i, i, i, vp]
        lib.sat_quad_fwd_strided_f32.restype = i
        lib.sat_quad_fwd_scratch_floats.argtypes = [i, i, i, i, i]
        lib.sat_quad_fwd_scratch_floats.restype = ll
        lib.sat_quad_bwd_strided_f32.argtypes = [vp, ll, ll, ll, vp, ll, vp, vp, vp, vp,
                                                 i, i, i, i, i, vp]
        lib.sat_quad_bwd_strided_f32.restype = i
        lib.sat_quad_bwd_design.argtypes = [i, i, i, i, i, ctypes.POINTER(ll)]
        lib.sat_quad_bwd_design.restype = i
        lib.sat_quad_tf32_passes.argtypes = []
        lib.sat_quad_tf32_passes.restype = i
        _libs[name] = lib
    return _libs[name]


def quad_diag_plain(xT: torch.Tensor, factors: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    """(..., L, N) from xT (..., N, m) and factors (L, m, m) or
    (..., L, m, m), materializing the product t at ``precision``
    (:func:`.precision.matmul`); autograd differentiates it. The plain
    version of :func:`quad_fwd_kernel`."""
    t = _precision.matmul(xT.unsqueeze(-3), factors, precision)  # (..., L, N, m)
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


def quad_fwd_kernel(x: torch.Tensor, F: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """Launch the forward kernel on the canonical form at ``precision``;
    returns (G, L, N)."""
    global fwd_launches, wgmma_launches
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
    lib = _library(precision)
    with torch.cuda.device(x.device):
        n = lib.sat_quad_fwd_scratch_floats(G, N, m, L, int(per_group))
        scratch = torch.empty((n,), dtype=x.dtype, device=x.device) if n > 0 else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sat_quad_fwd_strided_f32(
            x.data_ptr(), *x.stride(), F.data_ptr(), L * m * m if per_group else 0,
            out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            G, N, m, L, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"quad forward kernel launch failed with CUDA error {err} "
            f"(G={G}, N={N}, m={m}, L={L}, precision={precision})"
        )
    fwd_launches += 1
    wgmma_launches += int(n > 0)
    return out


def quad_bwd_kernel(x: torch.Tensor, F: torch.Tensor, dy: torch.Tensor,
                    precision: str = "highest"):
    """Launch the backward kernels on the canonical form at ``precision``;
    returns (dx, dF)."""
    global bwd_launches, wgmma_launches
    _check(x, F, "quad_bwd_kernel")
    G, N, m, L, per_group = _dims(x, F)
    if tuple(dy.shape) != (G, L, N) or dy.dtype != torch.float32 or dy.device != x.device:
        raise ValueError(f"quad_bwd_kernel: dy {tuple(dy.shape)} {dy.dtype}, want ({G}, {L}, {N})")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dF = torch.empty(F.shape, dtype=F.dtype, device=F.device)
    if dx.numel() == 0 or dF.numel() == 0:
        return dx.zero_(), dF.zero_()
    F, dy = F.contiguous(), dy.contiguous()
    n_groups = G if per_group else 1
    with torch.cuda.device(x.device):
        design = bwd_design(G, N, m, L, n_groups, precision)
        # The warpgroup-MMA design reads x at its strides (its first launch
        # makes the rounded copy it needs); the others take x by rows.
        if not design["wgmma"]:
            x = x.contiguous()
        scratch = torch.empty((design["scratch_floats"],), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library(precision).sat_quad_bwd_strided_f32(
            x.data_ptr(), *x.stride(), F.data_ptr(), L * m * m if per_group else 0,
            dy.data_ptr(), dx.data_ptr(), dF.data_ptr(), scratch.data_ptr(), G, N, m, L,
            n_groups, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"quad backward kernel launch failed with CUDA error {err} "
            f"(G={G}, N={N}, m={m}, L={L}, design={design})"
        )
    bwd_launches += 1
    wgmma_launches += design["wgmma"]
    return dx, dF


_DESIGN_KEYS = ("column_tiles", "block_rows", "chunk", "blocks_per_sm_dx", "blocks_per_sm_df",
                "splits_dx", "splits_df", "scratch_floats", "row_group_warps", "stages_dx",
                "stages_df", "wgmma")


@functools.lru_cache(maxsize=None)
def _design(device_index: int, G: int, N: int, m: int, L: int, n_groups: int,
            precision: str) -> tuple:
    out = (ctypes.c_longlong * len(_DESIGN_KEYS))()
    err = _library(precision).sat_quad_bwd_design(G, N, m, L, n_groups, out)
    if err != 0:
        raise RuntimeError(f"quad backward design query failed with CUDA error {err}")
    return tuple(int(v) for v in out)


def bwd_design(G: int, N: int, m: int, L: int, n_groups: int,
               precision: str = "highest") -> dict:
    """What the backward launches at these sizes on the current device
    (``csrc/quad.cu``): its column tiles (0 above m = 512, the wide
    variant), block rows, chunk depth, blocks per SM, splits of dx and of
    dF (each above 1 adds a fixed-order sum), the floats of scratch, the
    warps that share a group of 16 rows (2 above m = 256), the chunk
    buffers of the dx and the dF kernel (the ring's slots in the
    warpgroup-MMA design), ``wgmma`` (1 where that design runs: the
    one-pass build at m <= 256, m % 4 == 0; its chunk is the dx pass's
    columns of F a chunk, the accumulator's width to m = 200 and half of it
    above, and its scratch holds the rounded copies of x and F too), and
    the TF32 passes of a product at ``precision`` (3, or 1 for
    ``default``; the wide variant runs fp32 tiles whatever the name)."""
    values = _design(torch.cuda.current_device(), G, N, m, L, n_groups, precision)
    passes = _library(precision).sat_quad_tf32_passes()
    return {**dict(zip(_DESIGN_KEYS, values)), "tf32_passes": passes}


def quad_bwd_plain(x: torch.Tensor, F: torch.Tensor, dy: torch.Tensor,
                   precision: str = "highest"):
    """Plain version of :func:`quad_bwd_kernel`, the JAX package's pullback
    with its products at ``precision``: t = x F_b, w = 2 dy t,
    dx = sum_b w F_bᵀ, dF_b = sum_n xᵀ w."""
    with _precision.scope(precision, x):
        t = x.unsqueeze(1) @ F  # (G, L, N, m)
        w = 2.0 * t * dy.unsqueeze(-1)
        dx = (w @ F.transpose(-1, -2)).sum(dim=1)
        if F.dim() == 4:
            dF = torch.einsum("gni,gbnk->gbik", x, w)
        else:
            dF = torch.einsum("gni,gbnk->bik", x, w)
    return dx, dF


def _fwd(x, F, precision):
    global plain_calls
    if x.device.type == "cpu":
        plain_calls += 1
        return quad_diag_plain(x, F, precision)
    return quad_fwd_kernel(x, F, precision)


def _bwd(x, F, dy, precision):
    global plain_calls
    if x.device.type == "cpu":
        plain_calls += 1
        return quad_bwd_plain(x, F, dy, precision)
    return quad_bwd_kernel(x, F, dy, precision)


class _QuadDiag(torch.autograd.Function):
    @staticmethod
    def forward(x, F, precision):
        return _fwd(x, F, precision)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:2])
        ctx.precision = inputs[2]

    @staticmethod
    def backward(ctx, dy):
        x, F = ctx.saved_tensors
        return (*_bwd(x, F, dy, ctx.precision), None)

    @staticmethod
    def vmap(info, in_dims, x, F, precision):
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
        out = _QuadDiag.apply(x.reshape((R * G,) + tuple(x.shape[2:])), F, precision)
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


def quad_diag(xT: torch.Tensor, factors: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """Differentiable (..., L, N) quadratic-form diagonals through the
    kernels at ``precision`` (see the module doc for the two forms of
    ``factors`` and the two modes)."""
    lead = xT.shape[:-2]
    N, m = xT.shape[-2:]
    G = math.prod(lead)
    x3 = xT.reshape(G, N, m)
    F = _canonical_factors(factors, lead, G)
    out = _QuadDiag.apply(x3, F, _precision.check_name(precision))
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))
