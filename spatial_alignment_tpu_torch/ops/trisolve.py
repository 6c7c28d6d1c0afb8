"""Batched triangular solve and inverse: the hand-written CUDA kernel, its
plain version, and the solve-based backward.

Replaces ``spatial_alignment_tpu/ops/pallas_trisolve.py``: ``tri_solve``
(X = L^-1 B, or L^-T B with ``trans``) and ``tri_inverse`` (X = L^-1 with
the identity made in the kernel). The kernel is ``csrc/trisolve.cu``
(design and bound in its header), built with nvcc at first use and called
through ctypes on PyTorch's current stream. :mod:`.linalg` sends a solve
here only under ``cholesky_impl="pallas"``, as the JAX package does.

Dispatch is by the tensor's device alone: a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain version
(``torch.linalg.solve_triangular``). Nothing falls back from one to the
other. Only L's lower triangle is read.

The backward is the JAX package's custom VJP (``pallas_trisolve.py:387-433``):
for X = L^-1 B, B̄ = L^-T X̄ and L̄ = -tril(B̄ Xᵀ); for X = L^-T B,
B̄ = L^-1 X̄ and L̄ = -tril(X B̄ᵀ); for X = L^-1, L̄ = -tril(L^-T X̄ Xᵀ). The
solve in each goes back through the same dispatch (the kernel on the card),
the product stays ``torch.matmul``, as JAX leaves it outside the kernel.

Counters: ``launches`` counts kernel launches; ``plain_calls`` counts the
solves that took the plain version because their tensors lay on the CPU.
Set either to 0 before a run and read it after.
A captured training step counts once, at its capture; the training
loop (``models/train.py``) adds that step's counts once per replay.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "tri_solve",
    "tri_inverse",
    "tri_solve_kernel",
    "tri_inverse_kernel",
    "tri_solve_plain",
    "tri_inverse_plain",
    "uses_shared_memory",
]

COUNTERS = ("launches", "plain_calls")
launches = 0
plain_calls = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("trisolve")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sat_trisolve_f32.argtypes = [vp, ll, vp, vp, ll, i, i, i, i, vp]
        lib.sat_trisolve_f32.restype = i
        lib.sat_trisolve_uses_smem.argtypes = [i, i]
        lib.sat_trisolve_uses_smem.restype = i
        _lib = lib
    return _lib


def uses_shared_memory(m: int, n: int) -> bool:
    """Whether the kernel keeps an m x m factor in shared memory for an RHS
    of width n on the current device (else it reads L from global memory)."""
    r = _library().sat_trisolve_uses_smem(int(m), int(n))
    if r < 0:
        raise RuntimeError("could not query the device's shared-memory limit")
    return bool(r)


def _check_factor(L: torch.Tensor, what: str):
    if L.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {L.device}")
    if L.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {L.dtype}")
    if L.dim() < 2 or L.shape[-1] != L.shape[-2]:
        raise ValueError(f"{what}: expected L of shape (..., m, m), got {tuple(L.shape)}")


def _launch(L, l_stride, B, X, batch, m, n, trans, identity):
    global launches
    lib = _library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.sat_trisolve_f32(
            L.data_ptr(), l_stride, 0 if B is None else B.data_ptr(), X.data_ptr(),
            batch, m, n, int(trans), int(identity), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"trisolve kernel launch failed with CUDA error {err} "
            f"(batch={batch}, m={m}, n={n}, trans={trans}, identity={identity})"
        )
    launches += 1


def tri_solve_kernel(L: torch.Tensor, B: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """Launch the kernel: L (..., m, m) and B (..., m, n) float32 CUDA
    tensors with the same batch dims. A factor broadcast over the batch
    (every batch stride 0, as ``expand`` gives) is read once, not copied."""
    _check_factor(L, "tri_solve_kernel")
    if B.device != L.device or B.dtype != torch.float32:
        raise ValueError(f"tri_solve_kernel: B must be float32 on {L.device}")
    if B.shape[:-1] != L.shape[:-1]:
        raise ValueError(
            f"tri_solve_kernel: L {tuple(L.shape)} and B {tuple(B.shape)} do not match"
        )
    m, n = L.shape[-1], B.shape[-1]
    batch = math.prod(L.shape[:-2])
    out = torch.empty(B.shape, dtype=B.dtype, device=B.device)
    if batch == 0 or m == 0 or n == 0:
        return out
    if L.dim() > 2 and all(s == 0 for s in L.stride()[:-2]):
        Lk, l_stride = L[(0,) * (L.dim() - 2)].contiguous(), 0
    else:
        Lk, l_stride = L.contiguous(), m * m
    _launch(Lk, l_stride, B.contiguous(), out, batch, m, n, trans, False)
    return out


def tri_inverse_kernel(L: torch.Tensor) -> torch.Tensor:
    """Launch the kernel's identity-RHS form: L^-1 of (..., m, m) float32."""
    _check_factor(L, "tri_inverse_kernel")
    m = L.shape[-1]
    batch = math.prod(L.shape[:-2])
    out = torch.empty(L.shape, dtype=L.dtype, device=L.device)
    if batch == 0 or m == 0:
        return out
    _launch(L.contiguous(), m * m, None, out, batch, m, m, False, True)
    return out


def tri_solve_plain(L: torch.Tensor, B: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`tri_solve_kernel`."""
    if trans:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def tri_inverse_plain(L: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`tri_inverse_kernel`."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _solve(L, B, trans):
    global plain_calls
    if L.device.type == "cpu":
        plain_calls += 1
        return tri_solve_plain(L, B, trans)
    return tri_solve_kernel(L, B, trans)


def _inverse(L):
    global plain_calls
    if L.device.type == "cpu":
        plain_calls += 1
        return tri_inverse_plain(L)
    return tri_inverse_kernel(L)


class _TriSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L, B, trans):
        X = _solve(L, B, trans)
        ctx.trans = trans
        ctx.save_for_backward(L, X)
        return X

    @staticmethod
    def backward(ctx, Xbar):
        L, X = ctx.saved_tensors
        Bbar = _solve(L, Xbar, not ctx.trans)
        Lbar = None
        if ctx.needs_input_grad[0]:
            if ctx.trans:
                Lbar = -torch.tril(X @ Bbar.transpose(-1, -2))
            else:
                Lbar = -torch.tril(Bbar @ X.transpose(-1, -2))
        return Lbar, Bbar, None


class _TriInverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L):
        X = _inverse(L)
        ctx.save_for_backward(L, X)
        return X

    @staticmethod
    def backward(ctx, Xbar):
        L, X = ctx.saved_tensors
        G = _solve(L, Xbar, True)
        return -torch.tril(G @ X.transpose(-1, -2))


def tri_solve(L: torch.Tensor, B: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """Differentiable L^-1 B (L^-T B with ``trans``); the batch dims of the
    two broadcast against each other."""
    batch = torch.broadcast_shapes(L.shape[:-2], B.shape[:-2])
    L = L.expand(batch + L.shape[-2:])
    B = B.expand(batch + B.shape[-2:])
    return _TriSolve.apply(L, B, trans)


def tri_inverse(L: torch.Tensor) -> torch.Tensor:
    """Differentiable L^-1 of a batched lower-triangular factor."""
    return _TriInverse.apply(L)
