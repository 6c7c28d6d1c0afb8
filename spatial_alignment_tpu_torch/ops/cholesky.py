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
A captured training step counts once, at its capture; the training
loop (``models/train.py``) adds that step's counts once per replay.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "cholesky",
    "cholesky_kernel",
    "cholesky_plain",
    "blocks_per_matrix",
    "cholesky_recurrence",
    "design",
    "murray_backward",
    "uses_shared_memory",
]

COUNTERS = ("launches", "plain_calls")
launches = 0
plain_calls = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("cholesky")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sat_cholesky_f32.argtypes = [vp, vp, vp, ll, i, vp]
        lib.sat_cholesky_f32.restype = i
        lib.sat_cholesky_scratch_floats.argtypes = [ll, i]
        lib.sat_cholesky_scratch_floats.restype = ll
        lib.sat_cholesky_f32_blocks.argtypes = [vp, vp, vp, ll, i, i, vp]
        lib.sat_cholesky_f32_blocks.restype = i
        lib.sat_cholesky_blocks_per_matrix.argtypes = [ll, i]
        lib.sat_cholesky_blocks_per_matrix.restype = i
        lib.sat_cholesky_recurrence_f32.argtypes = [vp, vp, ll, i, vp]
        lib.sat_cholesky_recurrence_f32.restype = i
        lib.sat_cholesky_design.argtypes = [ctypes.c_int]
        lib.sat_cholesky_design.restype = ctypes.c_int
        lib.sat_cholesky_uses_smem.argtypes = [ctypes.c_int]
        lib.sat_cholesky_uses_smem.restype = ctypes.c_int
        lib.sat_cholesky_smem_bytes.argtypes = [ctypes.c_int]
        lib.sat_cholesky_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def uses_shared_memory(m: int) -> bool:
    """Whether the kernel keeps the whole m x m matrix in shared memory on
    the current device (m <= 240 on an H100); else it runs the panel design,
    with the trailing matrix in global memory."""
    return design(m) == "smem"


_DESIGNS = {0: "smem", 1: "panel_smem", 2: "panel_global"}


def design(m: int) -> str:
    """The kernel's design for an m x m matrix on the current device:
    ``"smem"`` (the whole matrix in shared memory), ``"panel_smem"`` (the
    trailing matrix in global memory, the 32-column panel in shared memory)
    or ``"panel_global"`` (the panel in scratch in global memory, which
    the wrapper allocates)."""
    r = _library().sat_cholesky_design(int(m))
    if r < 0:
        raise RuntimeError("could not query the device's shared-memory limit")
    return _DESIGNS[r]


def _symmetrize(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.transpose(-1, -2))


def blocks_per_matrix(batch: int, m: int) -> int:
    """Thread blocks the kernel gives each of ``batch`` m x m matrices on the
    current device: from m = 384 on, a thread-block cluster of 4 (or 2) in
    the panel design while the batch's clusters fit the card at once; else
    1."""
    r = _library().sat_cholesky_blocks_per_matrix(int(batch), int(m))
    if r < 0:
        raise RuntimeError("could not query the device")
    return r


def _check(a: torch.Tensor, what: str) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., m, m), got {tuple(a.shape)}")


def _launch(entry, a: torch.Tensor, what: str, scratch_floats=None, *extra) -> torch.Tensor:
    """Launch ``entry`` on ``a``; with ``scratch_floats`` it also takes a
    scratch buffer of that many floats (0: none, a null pointer) and the
    ``extra`` arguments before the stream."""
    a = a.contiguous()
    m = a.shape[-1]
    batch = math.prod(a.shape[:-2])
    out = torch.empty_like(a)
    if batch == 0 or m == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if scratch_floats is None:
            err = entry(a.data_ptr(), out.data_ptr(), batch, m, stream)
        else:
            n = scratch_floats(batch, m)
            if n < 0:
                raise RuntimeError("could not query the device's shared-memory limit")
            scratch = torch.empty(n, dtype=torch.float32, device=a.device) if n else None
            err = entry(a.data_ptr(), out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                        batch, m, *extra, stream)
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed with CUDA error {err} (batch={batch}, m={m})"
        )
    return out


def cholesky_kernel(a: torch.Tensor, blocks: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on a symmetric f32 (..., m, m) CUDA tensor.
    ``blocks`` forces the thread blocks a matrix (1, or a cluster of 2 to 8
    in the panel design with its panel in shared memory) to time one
    choice against another; None takes :func:`blocks_per_matrix`."""
    global launches
    _check(a, "cholesky_kernel")
    lib = _library()
    if blocks is None:
        out = _launch(lib.sat_cholesky_f32, a, "cholesky kernel", lib.sat_cholesky_scratch_floats)
    else:
        out = _launch(lib.sat_cholesky_f32_blocks, a, "cholesky kernel",
                      lib.sat_cholesky_scratch_floats, int(blocks))
    if math.prod(a.shape[:-2]) and a.shape[-1]:
        launches += 1
    return out


def cholesky_recurrence(a: torch.Tensor) -> torch.Tensor:
    """The column recurrence (one column a step, in global memory) on a
    symmetric f32 (..., m, m) CUDA tensor: the reference whose rounding
    :func:`cholesky_kernel` keeps bit for bit. For tests and the smoke only;
    no path calls it, and it counts no launch."""
    _check(a, "cholesky_recurrence")
    return _launch(_library().sat_cholesky_recurrence_f32, a, "cholesky recurrence")


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


def murray_backward(L: torch.Tensor, Lbar: torch.Tensor) -> torch.Tensor:
    """Cotangent of the symmetric input from the factor's, Murray (2016):
    S = L^T Lbar, P = tril(S) - diag(S)/2, Abar = 1/2 L^-T (P + P^T) L^-1,
    symmetrized, as ``pallas_cholesky._chol_bwd``."""
    S = L.transpose(-1, -2) @ Lbar
    P = torch.tril(S) - 0.5 * torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1))
    Psym = P + P.transpose(-1, -2)
    Lt = L.transpose(-1, -2)
    tmp = torch.linalg.solve_triangular(Lt, Psym, upper=True)  # L^-T Psym
    X = torch.linalg.solve_triangular(
        Lt, tmp.transpose(-1, -2), upper=True
    ).transpose(-1, -2)
    return 0.25 * (X + X.transpose(-1, -2))


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        L = _forward(a)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        return murray_backward(L, Lbar)


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Differentiable batched lower Cholesky of (..., m, m) (see module doc)."""
    return _Cholesky.apply(a)
