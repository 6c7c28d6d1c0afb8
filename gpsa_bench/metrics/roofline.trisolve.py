"""Roofline share of one operation in the cell's step: the triangular solves and inverses
(``ops.trisolve.tri_solve`` and ``tri_inverse``), forward, at fp32's peak.

The harness spies on the entry points in ``OP["patch"]`` during one eager
loss and gradient of the cell's model, keeps every call's inputs, and
times each call alone by CUDA events."""

from gpsa_bench.metrics._roofline import share
from gpsa_bench.work import trisolve

OP = {"name": "trisolve", "backward": False,
      "patch": [("spatial_alignment_tpu_torch.ops.trisolve", "tri_solve"),
                 ("spatial_alignment_tpu_torch.ops.trisolve", "tri_inverse")]}


def read(ctx):
    return share(ctx["ops"].get(OP["name"]), trisolve.forward, ctx["peaks"],
                 lambda args: "fp32", "fwd")
