"""Share of the profiled call's wall time in which no operation ran
on the device."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
