"""Mean host-clock ms of a `QueryEncoder.embed_texts` call over the
window's waves (encoder layer; the call ends in the copy of its output
to the host, so it holds its device work)."""
from bench.metrics._read import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "encoder")
