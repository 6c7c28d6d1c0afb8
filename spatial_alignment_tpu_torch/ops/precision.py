"""The SVGP products at the JAX package's precision names.

Counterpart of the JAX package's ``jax.default_matmul_precision`` scopes
around the SVGP products (``spatial_alignment_tpu/models/core.py:204-268``).
The names count the TPU matrix unit's bf16 passes; on an NVIDIA Hopper card
they mean:

  ``default``  one TF32 pass: cuBLAS with TF32 enabled (operands rounded to
               10 mantissa bits, about 2^-11 each, fp32 sums), JAX's own
               GPU meaning of ``DEFAULT``. The TPU's one bf16 pass keeps 7.
  ``high``     fp32 in cuBLAS: better than the TPU's bf16_3x (about 16
               bits). The products at ``high`` are the width-C mean
               products, latency-bound, which a split into three TF32
               GEMMs would only lengthen.
  ``highest``  fp32.

:func:`matmul` is ``a @ b`` at one of these names. On a CUDA tensor whose
name's mode differs from what PyTorch's process-wide setting gives when the
product is formed (``default`` while TF32 is off, PyTorch's default; ``high``
or ``highest`` while it is on) it is :class:`_Matmul`, whose forward and
both backward GEMMs run inside :func:`scope` (JAX's backward
``dot_general`` carries the forward's precision; a scope around the
forward's ``@`` would not reach autograd's backward GEMMs). Where the two
agree it is the plain ``@``, whose autograd GEMMs keep their own layouts
(the Function's backward products take others: 5-7 % slower a step where
every product went through it, PERF.md); its backward then runs in the setting in force, so the
setting must not change between a forward and its backward. Every CPU
tensor takes the plain fp32 ``@``, as XLA on the CPU ignores the names.

:func:`scope` sets cuBLAS's TF32 flag from the name for the GEMMs issued
inside it, in both directions: on at ``default``, off at ``high`` and
``highest``, whatever PyTorch's process-wide setting (``allow_tf32``,
``set_float32_matmul_precision`` or ``fp32_precision``) reads. It puts that
setting back in a ``finally``, so that each of those reads the same before
and after. The math mode is fixed when a GEMM is issued, so a CUDA graph
captured inside the scope replays the GEMMs in the name's mode whatever the
flags say later.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["NAMES", "check_name", "matmul", "scope", "tf32", "tf32_enabled"]

NAMES = ("default", "high", "highest")


def check_name(precision: str) -> str:
    if precision not in NAMES:
        raise ValueError(f"precision must be one of {NAMES}, got {precision!r}")
    return precision


def _read(getter):
    """A flag's value, or None where PyTorch refuses to read it (a legacy
    getter after only the per-backend ``fp32_precision`` was set)."""
    try:
        return getter()
    except RuntimeError:
        return None


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuBLAS TF32 on or off for the GEMMs issued inside; PyTorch's
    process-wide setting put back after, as each of its readers read it."""
    mm = torch.backends.cuda.matmul
    per_backend = mm.fp32_precision
    matmul_precision = _read(torch.get_float32_matmul_precision)
    allowed = _read(lambda: mm.allow_tf32)
    mm.allow_tf32 = enabled
    try:
        yield
    finally:
        # The legacy setters also write the per-backend value ("ieee" or
        # "tf32"), which is put back last.
        if matmul_precision is not None:
            torch.set_float32_matmul_precision(matmul_precision)
        elif allowed is not None:
            mm.allow_tf32 = allowed
        else:
            # Both legacy readers refuse when the legacy setting disagrees
            # with the per-backend one: it is the other way round.
            mm.allow_tf32 = per_backend != "tf32"
        if mm.fp32_precision != per_backend:
            mm.fp32_precision = per_backend


@contextlib.contextmanager
def scope(precision: str, t: torch.Tensor):
    """The GEMMs issued inside run at ``precision`` (module doc) on a CUDA
    ``t``; on the CPU nothing changes."""
    if check_name(precision) and t.device.type != "cuda":
        yield
        return
    with tf32(precision == "default"):
        yield


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` summed over the dims broadcasting added to ``shape``."""
    lead = t.dim() - len(shape)
    if lead:
        t = t.sum(dim=tuple(range(lead)))
    return t.sum_to_size(shape)


class _Matmul(torch.autograd.Function):
    """``a @ b`` (both at least 2-D) with its forward and backward GEMMs
    inside :func:`scope` at the name it is given."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b, precision):
        with scope(precision, a):
            return a @ b

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, ctx.precision = inputs
        ctx.save_for_backward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with scope(ctx.precision, g):
            if ctx.needs_input_grad[0]:
                ga = _sum_to(g @ b.transpose(-1, -2), a.shape)
            if ctx.needs_input_grad[1]:
                gb = _sum_to(a.transpose(-1, -2) @ g, b.shape)
        return ga, gb, None


def tf32_enabled() -> bool:
    """Whether PyTorch's process-wide setting runs float32 cuBLAS GEMMs in
    TF32."""
    mm = torch.backends.cuda.matmul
    allowed = _read(lambda: mm.allow_tf32)
    return mm.fp32_precision == "tf32" if allowed is None else allowed


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` at ``precision`` (module doc); both at least 2-D."""
    tf32_name = check_name(precision) == "default"
    if a.device.type == "cuda" and tf32_name != tf32_enabled():
        return _Matmul.apply(a, b, precision)
    return a @ b
