"""The port's `host_syncs` counter a wave (program_counter): the host
calls of the route path that wait for the card (the encoder's copies in
and out and its RoPE frequencies' copies, the queries' and lambdas'
copies in, the five outputs' copies out, a device cache's refill), over
the window's waves."""
from bench.metrics._program import count_a_wave


def read(ctx):
    return count_a_wave("host_syncs")
