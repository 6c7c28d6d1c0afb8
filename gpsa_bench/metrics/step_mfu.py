"""Model operations of a step (``work/step.py``: the forward of the
negative ELBO, the backward at twice it) over the step
time of the traced run's unprofiled window, as a share of the card's TF32
peak, the highest rate the step's products may run at under its
precision names."""

from gpsa_bench.work import step


def read(ctx):
    window = ctx.get("window")
    if not window or not window["steps"]:
        return None
    step_s = window["seconds"] / window["steps"]
    return 100.0 * step.step_flops(ctx["config"], ctx["traffic"]) / step_s / ctx["peaks"]["tf32"]
