"""Operations and bytes of each operation the benchmark rates, counted from
the operation's mathematics at its shapes, whatever implements it: each
input element read once, each output element written once (a tensor whose
batch dims are broadcast, stride 0, is one tensor), no rereads, and a
product's operations counted once whatever number of passes a build makes.
One module an operation; ``step`` counts a whole training step."""

from __future__ import annotations

import math

F32 = 4  # bytes of a float32


def unique_numel(t) -> int:
    """Elements of ``t`` in memory: broadcast (stride 0) dims count once."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)


def batch(t) -> int:
    """The product of ``t``'s leading dims before its last two."""
    return math.prod(t.shape[:-2])
