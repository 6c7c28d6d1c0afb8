"""Share of a profiled call's wall time in which the device idled while the
host was inside ``gpsa.fit`` and the idle was not inside one graph replay:
the host's chunk copies, loss waits, optimizer reset and the gaps between
two replays. Read in the span replica (``metrics/_spanrun.py``)."""

from gpsa_bench.metrics._spanrun import result


def read(ctx):
    return result(ctx).get("call", {}).get("host_share")
