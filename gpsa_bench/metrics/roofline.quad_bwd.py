"""Roofline share of one operation in the cell's step: the quadratic-form diagonals
(``ops.quad.quad_diag``), autograd backward, at the peak of the call's
precision name.

The harness spies on the entry points in ``OP["patch"]`` during one eager
loss and gradient of the cell's model, keeps every call's inputs, and
times each call alone by CUDA events."""

from gpsa_bench.metrics._roofline import share
from gpsa_bench.work import quad

OP = {"name": "quad", "backward": True,
      "patch": [("spatial_alignment_tpu_torch.ops.quad", "quad_diag")]}


def read(ctx):
    return share(ctx["ops"].get(OP["name"]), quad.backward, ctx["peaks"],
                 lambda args: quad.rate(args[2] if len(args) > 2 else "highest"), "bwd")
