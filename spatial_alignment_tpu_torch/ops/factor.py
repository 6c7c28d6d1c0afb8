"""Batched Cholesky factor and its inverse in one launch: the hand-written
CUDA kernel, its plain version, and the composed backward.

Replaces ``spatial_alignment_tpu/ops/pallas_factor.py:cholesky_and_inverse``.
The kernel is ``csrc/factor.cu`` (design and bound in its header), built
with nvcc at first use and called through ctypes on PyTorch's current
stream. :mod:`.linalg` sends the final factor slab here only under
``fused_factor_inverse="fused"``, as the JAX package does.

Dispatch is by the tensor's device alone: a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain version (``cholesky_ex``, then
``solve_triangular`` against the identity). Nothing falls back from one to
the other.

Semantics follow :mod:`.cholesky`: the input is symmetrized as
0.5 (A + A^T) first, and an indefinite matrix gives NaN over the whole
lower triangle of both L and L^-1 (0 above), leaving the other matrices of
the batch unaffected.

The backward is the JAX package's ``_fused_bwd`` (``pallas_factor.py:306-326``):
the inverse's pullback, L̄ += -tril(L^-T (L^-1)̄ (L^-1)ᵀ), then Murray's
Cholesky pullback, with ``torch.linalg.solve_triangular`` for the solves
because JAX leaves them to XLA.

Counters: ``launches`` counts kernel launches; ``plain_calls`` counts calls
that took the plain version because their tensor lay on the CPU.
A captured training step counts once, at its capture; the training
loop (``models/train.py``) adds that step's counts once per replay.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build
from .cholesky import murray_backward

__all__ = [
    "cholesky_and_inverse",
    "cholesky_and_inverse_kernel",
    "cholesky_and_inverse_plain",
    "design",
    "uses_shared_memory",
]

COUNTERS = ("launches", "plain_calls")
launches = 0
plain_calls = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("factor")
        vp = ctypes.c_void_p
        lib.sat_factor_f32.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
        lib.sat_factor_f32.restype = ctypes.c_int
        lib.sat_factor_scratch_floats.argtypes = [ctypes.c_longlong, ctypes.c_int]
        lib.sat_factor_scratch_floats.restype = ctypes.c_longlong
        lib.sat_factor_uses_smem.argtypes = [ctypes.c_int]
        lib.sat_factor_uses_smem.restype = ctypes.c_int
        lib.sat_factor_design.argtypes = [ctypes.c_int]
        lib.sat_factor_design.restype = ctypes.c_int
        _lib = lib
    return _lib


def uses_shared_memory(m: int) -> bool:
    """Whether the kernel keeps the whole m x m factor and its inverse in
    shared memory on the current device (m <= 240 on an H100); else it runs
    the panel design, with both matrices in global memory."""
    return design(m) == "smem"


_DESIGNS = {0: "smem", 1: "panel_smem", 2: "panel_global"}


def design(m: int) -> str:
    """The kernel's design for an m x m factor on the current device:
    ``"smem"``, ``"panel_smem"`` (L and L^-1 in global memory, L's panel
    and a block row of L^-1 in shared memory) or ``"panel_global"`` (those
    in scratch in global memory, which the wrapper allocates)."""
    r = _library().sat_factor_design(int(m))
    if r < 0:
        raise RuntimeError("could not query the device's shared-memory limit")
    return _DESIGNS[r]


def cholesky_and_inverse_kernel(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on a symmetric f32 (..., m, m) CUDA tensor."""
    global launches
    if a.device.type != "cuda":
        raise ValueError(f"cholesky_and_inverse_kernel needs a CUDA tensor, got {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"cholesky_and_inverse_kernel takes float32, got {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., m, m), got {tuple(a.shape)}")
    a = a.contiguous()
    m = a.shape[-1]
    batch = math.prod(a.shape[:-2])
    L, Linv = torch.empty_like(a), torch.empty_like(a)
    if batch == 0 or m == 0:
        return L, Linv
    lib = _library()
    n = lib.sat_factor_scratch_floats(batch, m)
    if n < 0:
        raise RuntimeError("could not query the device's shared-memory limit")
    scratch = torch.empty(n, dtype=torch.float32, device=a.device) if n else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.sat_factor_f32(
            a.data_ptr(), L.data_ptr(), Linv.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), batch, m, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"factor kernel launch failed with CUDA error {err} (batch={batch}, m={m})"
        )
    launches += 1
    return L, Linv


def cholesky_and_inverse_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version with the kernel's NaN contract."""
    L, info = torch.linalg.cholesky_ex(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(a.shape)
    Linv = torch.tril(torch.linalg.solve_triangular(L, eye, upper=False))
    failed = (info != 0)[..., None, None]
    nan_lower = torch.tril(torch.full_like(L, float("nan")))
    return torch.where(failed, nan_lower, L), torch.where(failed, nan_lower, Linv)


def _forward(a: torch.Tensor):
    global plain_calls
    sym = 0.5 * (a + a.transpose(-1, -2))
    if a.device.type == "cpu":
        plain_calls += 1
        return cholesky_and_inverse_plain(sym)
    return cholesky_and_inverse_kernel(sym)


class _CholeskyAndInverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        L, Linv = _forward(a)
        ctx.save_for_backward(L, Linv)
        return L, Linv

    @staticmethod
    def backward(ctx, Lbar, Linvbar):
        L, Linv = ctx.saved_tensors
        Lbar = torch.zeros_like(L) if Lbar is None else Lbar
        if Linvbar is not None:
            # X = L^-1: Lbar += -tril(L^-T Xbar X^T), the solve-based form.
            G = torch.linalg.solve_triangular(L.transpose(-1, -2), Linvbar, upper=True)
            Lbar = Lbar - torch.tril(G @ Linv.transpose(-1, -2))
        return murray_backward(L, Lbar)


def cholesky_and_inverse(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (L, L^-1) of a batched (..., m, m) SPD matrix."""
    return _CholeskyAndInverse.apply(a)
