"""Seconds of set-up inside ``gpsa.model.init`` (``VariationalGPSA``'s
constructor: spec, host k-means of the inducing points, parameters, the
packed batch), in the span replica's set-up (``metrics/_spanrun.py``)."""

from gpsa_bench.metrics._spanrun import result


def read(ctx):
    return result(ctx).get("setup", {}).get("model_s")
