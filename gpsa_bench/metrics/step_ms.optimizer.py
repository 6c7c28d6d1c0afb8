"""Device ms a step of the operations of the optimizer's work in the step
(``TrainLoop._step``), forward and backward: one eager run of the captured
step, each device operation given to the ``gpsa.*`` span that launched it (a
backward one to its forward's), in the span replica
(``metrics/_spanrun.py``)."""

from gpsa_bench.metrics._spanrun import step_ms


def read(ctx):
    return step_ms(ctx, "optimizer")
