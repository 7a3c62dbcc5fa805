"""Mean host-clock ms of a `KNNRouter.serve_fused` call over the window's
waves (router layer; the call ends in the copy of its results to the
host)."""
from bench.metrics._read import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "router")
