"""Batched lower Cholesky: the hand-written CUDA kernel, its plain version,
and Murray's backward.

Replaces ``spatial_alignment_tpu/ops/pallas_cholesky.py:cholesky``. The
kernel is ``csrc/cholesky.cu`` (design and bound in its header), built with
nvcc at first use and called through ctypes on PyTorch's current stream.

Dispatch is by the tensor's device alone: a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain version. Nothing falls back from
one to the other.

Semantics follow ``jnp.linalg.cholesky``: the input is symmetrized as
0.5 (A + A^T) first, and an indefinite matrix gives NaN over its whole lower
triangle (0 above), leaving the other matrices of the batch unaffected. The
jitter probes in :mod:`.linalg` depend on that NaN.

Counters: ``launches`` counts kernel launches, ``plain_calls`` calls of the
plain version. Set either to 0 before a run and read it after.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["cholesky", "cholesky_kernel", "cholesky_plain", "uses_shared_memory"]

launches = 0
plain_calls = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("cholesky")
        lib.sat_cholesky_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.sat_cholesky_f32.restype = ctypes.c_int
        lib.sat_cholesky_uses_smem.argtypes = [ctypes.c_int]
        lib.sat_cholesky_uses_smem.restype = ctypes.c_int
        _lib = lib
    return _lib


def uses_shared_memory(m: int) -> bool:
    """Whether the kernel keeps an m x m matrix in shared memory on the
    current device (else it runs the global-memory variant)."""
    r = _library().sat_cholesky_uses_smem(int(m))
    if r < 0:
        raise RuntimeError("could not query the device's shared-memory limit")
    return bool(r)


def _symmetrize(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.transpose(-1, -2))


def cholesky_kernel(a: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a symmetric f32 (..., m, m) CUDA tensor."""
    global launches
    if a.device.type != "cuda":
        raise ValueError(f"cholesky_kernel needs a CUDA tensor, got {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"cholesky_kernel takes float32, got {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., m, m), got {tuple(a.shape)}")
    a = a.contiguous()
    m = a.shape[-1]
    batch = math.prod(a.shape[:-2])
    out = torch.empty_like(a)
    if batch == 0 or m == 0:
        return out
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.sat_cholesky_f32(a.data_ptr(), out.data_ptr(), batch, m, stream)
    if err != 0:
        raise RuntimeError(
            f"cholesky kernel launch failed with CUDA error {err} "
            f"(batch={batch}, m={m})"
        )
    launches += 1
    return out


def cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the kernel's NaN contract.

    ``torch.linalg.cholesky_ex`` returns finite garbage plus ``info > 0`` for
    an indefinite matrix; that matrix's lower triangle becomes NaN here."""
    global plain_calls
    plain_calls += 1
    L, info = torch.linalg.cholesky_ex(a)
    nan_lower = torch.tril(torch.full_like(L, float("nan")))
    return torch.where((info != 0)[..., None, None], nan_lower, L)


def _forward(a: torch.Tensor) -> torch.Tensor:
    sym = _symmetrize(a)
    if a.device.type == "cpu":
        return cholesky_plain(sym)
    return cholesky_kernel(sym)


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        L = _forward(a)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        # Murray (2016): S = L^T Lbar, P = tril(S) - diag(S)/2,
        # Abar = 1/2 L^-T (P + P^T) L^-1, as pallas_cholesky._chol_bwd.
        (L,) = ctx.saved_tensors
        S = L.transpose(-1, -2) @ Lbar
        P = torch.tril(S) - 0.5 * torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1))
        Psym = P + P.transpose(-1, -2)
        Lt = L.transpose(-1, -2)
        tmp = torch.linalg.solve_triangular(Lt, Psym, upper=True)  # L^-T Psym
        X = torch.linalg.solve_triangular(
            Lt, tmp.transpose(-1, -2), upper=True
        ).transpose(-1, -2)
        return 0.25 * (X + X.transpose(-1, -2))


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Differentiable batched lower Cholesky of (..., m, m) (see module doc)."""
    return _Cholesky.apply(a)
