"""Share of the traced training window in which no operation ran on the
card: 1 - the union of the device's operation intervals over the window,
in %."""
from bench.metrics._read import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
