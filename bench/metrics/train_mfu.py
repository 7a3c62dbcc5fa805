"""The training step's share of the card's peak: model operations (6 a
matmul weight a token, plus causal attention, no recomputation) of the
window's steps over the window at 989 TFLOP/s bf16 (data sheet, 700 W),
in %."""
from bench.metrics._read import train_mfu_pct


def read(ctx):
    return train_mfu_pct(ctx)
