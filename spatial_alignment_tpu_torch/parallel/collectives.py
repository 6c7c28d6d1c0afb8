"""The collectives of the distributed path, counted.

Every collective the port issues goes through this module, which counts it
as :mod:`..ops` counts kernel launches: one call and its payload bytes
under ``<kind>_<group>_calls`` and ``<kind>_<group>_bytes``, for the kinds
``all_reduce``, ``all_gather`` and ``barrier`` and the groups ``world``,
``data`` and ``model`` (the mesh's dimensions). The module registers
itself with :mod:`..ops` when it is imported, so ``ops.read_counters``
reads them as ``collectives.<name>`` and a captured training step's
collectives are counted once per replay like its kernels.

Two autograd Functions carry the distributed step's gradient rule
(:mod:`.shardmap`): :class:`ReplicatedGrads` is the identity in the forward
and sums its inputs' gradients over a group in one flattened all-reduce in
the backward (the transpose of using one replicated value on every rank);
:class:`SumOverGroup` sums over a group in the forward and sums the
cotangent over the same group in the backward.
"""

from __future__ import annotations

from typing import List, Optional

import sys

import torch
import torch.distributed as dist

from .. import ops

KINDS = ("all_reduce", "all_gather", "barrier")
GROUPS = ("world", "data", "model")
COUNTERS = tuple(f"{k}_{g}_{w}" for k in KINDS for g in GROUPS for w in ("calls", "bytes"))
for _name in COUNTERS:
    globals()[_name] = 0
del _name
ops.register_counted("collectives", sys.modules[__name__])


def _count(kind: str, group: str, nbytes: int):
    g = globals()
    g[f"{kind}_{group}_calls"] += 1
    g[f"{kind}_{group}_bytes"] += int(nbytes)


class Comm:
    """One process group of a mesh and its name (``world``, ``data`` or
    ``model``) for the counters."""

    def __init__(self, name: str, group, size: int):
        self.name, self.group, self.size = name, group, int(size)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; returns it."""
        _count("all_reduce", self.name, t.numel() * t.element_size())
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The group's tensors, each of ``t``'s shape, joined along ``dim``
        in the group's rank order."""
        t = t.contiguous()
        _count("all_gather", self.name, t.numel() * t.element_size() * self.size)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return torch.cat(out, dim=dim)

    def barrier(self):
        _count("barrier", self.name, 0)
        dist.barrier(group=self.group)


class ReplicatedGrads(torch.autograd.Function):
    """``apply(comm, *leaves)`` returns the leaves unchanged; the backward
    sums their gradients over ``comm``'s group in one all-reduce of a
    flattened buffer. A leaf no gradient reached keeps ``None`` (it is
    unused on every rank: the ranks run one program)."""

    @staticmethod
    def forward(ctx, comm: Comm, *leaves):
        ctx.comm = comm
        ctx.set_materialize_grads(False)
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in leaves]
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        parts = [
            (g if g is not None else torch.zeros(s, dtype=dt, device=dev)).reshape(-1)
            for g, (s, dt, dev) in zip(grads, ctx.shapes)
        ]
        flat = ctx.comm.all_reduce(torch.cat(parts))
        out, off = [None], 0
        for g, p in zip(grads, parts):
            n = p.numel()
            out.append(None if g is None else flat[off : off + n].view_as(g))
            off += n
        return tuple(out)


class SumOverGroup(torch.autograd.Function):
    """``apply(comm, x)``: the sum of every rank's ``x`` over the group; its
    backward sums the cotangent over the group, the transpose when each
    rank's loss holds the sum with its own weight."""

    @staticmethod
    def forward(ctx, comm: Comm, x):
        ctx.comm = comm
        return comm.all_reduce(x.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.comm.all_reduce(grad.contiguous().clone())


class ValueOf(torch.autograd.Function):
    """``apply(objective, value)``: ``value``'s value with ``objective``'s
    gradient (the step reports the global loss and backpropagates the
    rank's own objective)."""

    @staticmethod
    def forward(ctx, objective, value):
        return value.detach().clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def replicated(comm: Optional[Comm], leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """``leaves`` through :class:`ReplicatedGrads` over ``comm`` (unchanged
    when ``comm`` is None or no leaf wants a gradient)."""
    if comm is None or not any(t.requires_grad for t in leaves):
        return list(leaves)
    return list(ReplicatedGrads.apply(comm, *leaves))
