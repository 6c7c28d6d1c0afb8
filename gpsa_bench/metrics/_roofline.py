"""Shared arithmetic of the ``roofline.*`` readers: the least time of an
operation's calls in a step at the card's peaks (``work/``) over their
device time by CUDA events, as a share."""

from gpsa_bench.peaks import least_seconds


def share(calls, work, peaks, rate, direction="fwd"):
    """``calls``: [{"args": [...], "fwd_ms": t, "bwd_ms": t}] of one step;
    ``work(*args)`` their operations and bytes; ``rate(args)`` the peak name.
    None when the step made no call."""
    if not calls:
        return None
    bound = 0.0
    for c in calls:
        w = work(*c["args"])
        bound += least_seconds(w["flops"], w["bytes"], peaks, rate(c["args"]))
    seconds = sum(c[f"{direction}_ms"] for c in calls) / 1e3
    return 100.0 * bound / seconds
