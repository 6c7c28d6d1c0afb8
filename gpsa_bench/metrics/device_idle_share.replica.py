"""Share of the span replica's profiled call's wall time in which no
operation ran on the device: the whole that ``idle_in_graph_share`` and
``idle_host_share`` split (with the idle while the host is outside
``gpsa.fit``, logged). ``device_idle_share`` reads the run's own call,
another call in another process (``metrics/_spanrun.py``)."""

from gpsa_bench.metrics._spanrun import result


def read(ctx):
    return result(ctx).get("call", {}).get("idle_share")
