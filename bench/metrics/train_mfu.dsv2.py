"""The DeepSeek-V2 step's share of the card's peak: 6 x the matmul
weights outside the routed experts x tokens, plus 6 x 3 d f x the rows
the held experts computed (the port's ``moe.held_rows`` counter), plus 6
(dk + dv) a kept pair a head of causal attention, no recomputation, over
the window at 989 TFLOP/s bf16 (data sheet, 700 W), in %."""
from bench.metrics._dsv2 import train_mfu_pct


def read(ctx):
    return train_mfu_pct(ctx)
