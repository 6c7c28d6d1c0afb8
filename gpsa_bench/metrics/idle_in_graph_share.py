"""Share of a profiled call's wall time in which the device idled between
two operations of one graph replay (both carry the correlation id of one
``cudaGraphLaunch``): bubbles inside the captured step, which no host
change removes. Read in the span replica (``metrics/_spanrun.py``)."""

from gpsa_bench.metrics._spanrun import result


def read(ctx):
    return result(ctx).get("call", {}).get("in_graph_share")
