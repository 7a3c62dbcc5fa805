"""How unevenly the router loads the held experts: the rows of the
busiest held expert (``moe.held_peak_rows``, a call each, summed) over
the held experts' mean (``moe.held_rows`` / the experts held), over the
window's MoE calls; 1 is even."""
from bench.metrics._dsv2 import moe_imbalance


def read(ctx):
    return moe_imbalance(ctx)
