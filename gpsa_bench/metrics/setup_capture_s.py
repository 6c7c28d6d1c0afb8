"""Seconds of set-up inside ``gpsa.loop.build`` (the optimizer's and the
training loop's construction: priming, warm-up steps, capture) less the
kernel libraries built or loaded inside it (``gpsa.ops.build``: a
checkout's first run compiles them, later runs load them), in the span
replica's set-up (``metrics/_spanrun.py``)."""

from gpsa_bench.metrics._spanrun import result


def read(ctx):
    return result(ctx).get("setup", {}).get("capture_s")
