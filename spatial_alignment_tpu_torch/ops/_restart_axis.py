"""The restart axis of ``torch.func.vmap`` folded into the kernels' batch.

Counterpart of the JAX package's ``custom_vmap`` rules
(``ops/pallas_cholesky.py``, ``pallas_factor.py``, ``pallas_trisolve.py``)
and of its ``vmap`` over ``pallas_gram``'s ``x2``: every autograd Function
around a kernel has a ``vmap`` staticmethod that moves the vmapped dim to
the front and calls the Function once on the whole batch, so R vmapped
restarts launch each kernel once, with R times its batch, and not R times.
"""

from __future__ import annotations

import torch


def to_front(x: torch.Tensor, bdim, size: int) -> torch.Tensor:
    """``x`` with its vmapped dim ``bdim`` first; an unbatched ``x``
    (``bdim`` None) expanded along a new first dim of ``size``."""
    if bdim is None:
        return x.expand((size,) + tuple(x.shape))
    return x.movedim(bdim, 0)
