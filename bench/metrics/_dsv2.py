"""The yardstick of the DeepSeek-V2 cell (`train.deepseek-v2.s4k`): the
operations and bytes of its MLA attention kernels and of its training
step, computed from shapes, and the readers of its four per-layer
metrics.  Each reader returns None where the run gave it nothing to read
(no trace, no such kernel, a program without the counters)."""
from __future__ import annotations

from bench import roofline
from bench.profiling import kernel_time


def mla_fwd_cost(B, S, H, dk, dv, elt):
    """(flops, bytes) of one causal forward call at q / k dim ``dk`` and v
    dim ``dv``: QK^T (2 dk) and PV (2 dv) over the kept pairs a head; q, k,
    v read once, o written once, the f32 log-sum-exp row written once (H =
    KV: MLA's keys are per head)."""
    pairs = roofline.attended_pairs(S, S, True)
    flops = 2.0 * (dk + dv) * B * H * pairs
    nbytes = elt * B * S * H * (2 * dk + 2 * dv) + 4.0 * B * H * S
    return flops, nbytes


def mla_bwd_cost(B, S, H, dk, dv, elt):
    """(flops, bytes) of one backward call: S = QK^T recomputed (2 dk),
    dP = dO V^T (2 dv), dV = P^T dO (2 dv), dQ = dS K and dK = dS^T Q (2 dk
    each): 6 dk + 4 dv a kept pair a head; q, k, v, dO, the f32 o and the
    log-sum-exp read once, dq, dk, dv written once."""
    pairs = roofline.attended_pairs(S, S, True)
    flops = (6.0 * dk + 4.0 * dv) * B * H * pairs
    nbytes = (elt * B * S * H * (3 * dk + 3 * dv) + 4.0 * B * S * H * dv
              + 4.0 * B * H * S)
    return flops, nbytes


def mla_weights(d, H, q_lora, kv_lora, nope, rope, dv):
    """Matmul weights a token multiplies in one MLA layer."""
    return (d * q_lora + q_lora * H * (nope + rope) + d * (kv_lora + rope)
            + kv_lora * H * nope + kv_lora * H * dv + H * dv * d)


def dense_weights(s):
    """Matmul weights a token multiplies outside the routed experts: the
    MLA layers, the dense FFN, the MoE layers' router and shared experts,
    the LM head (the embedding is a lookup)."""
    L = s["dense_layers"] + s["moe_layers"]
    attn = L * mla_weights(s["d"], s["H"], s["q_lora"], s["kv_lora"],
                           s["nope"], s["rope"], s["dv"])
    ffn = s["dense_layers"] * 3 * s["d"] * s["d_ff"]
    moe = s["moe_layers"] * (s["d"] * s["experts"]
                             + 3 * s["d"] * s["shared"] * s["f"])
    return attn + ffn + moe + s["d"] * s["vocab"]


def train_flops(s, held_rows):
    """Model operations of one step: 6 a matmul weight a token outside the
    routed experts, 6 x 3 d f a held (token, choice) row the held experts
    computed (``held_rows`` a step), and causal attention, 6 (dk + dv) a
    kept pair a head, over every layer.  No recomputation is counted."""
    tokens = s["B"] * s["S"]
    L = s["dense_layers"] + s["moe_layers"]
    attn = L * 6.0 * (s["dk"] + s["dv"]) * s["B"] * s["H"] \
        * roofline.attended_pairs(s["S"], s["S"], True)
    return (6.0 * dense_weights(s) * tokens
            + 6.0 * 3 * s["d"] * s["f"] * held_rows + attn)


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _names(tr, *parts):
    return [n for n in tr["kernels"] if all(p in n for p in parts)]


def _time(tr, names):
    t = c = 0
    for n in names:
        s, k = tr["kernels"][n]
        t += s
        c += k
    return t, c


def mla_roofline_pct(ctx, backward):
    """The (192, 128) kernel's least time a call by the step's shapes, times
    its calls in the trace, over the device time of its kernels (the
    backward's: its delta kernel at v 128 and the dQ / dK-dV kernel)."""
    tr = ctx.get("trace")
    if not tr:
        return None
    s = ctx["shape"]
    dk, dv = str(s["dk"]), str(s["dv"])
    if backward:
        main = _names(tr, "flash_bwd_kernel<", dk, dv)
        others = _names(tr, "flash_bwd_delta_kernel<", f", {dv}>")
        cost = mla_bwd_cost
    else:
        main, others = _names(tr, "flash_fwd_kernel_tc<", dk, dv), []
        cost = mla_fwd_cost
    _, calls = _time(tr, main)
    t, _ = _time(tr, main + others)
    if t <= 0 or calls == 0:
        return None
    flops, nbytes = cost(s["B"], s["S"], s["H"], s["dk"], s["dv"], s["elt"])
    return 100.0 * roofline.bound(nbytes, flops, s["dtype"])[0] * calls / t


def counter(ctx, name):
    c = ctx.get("counters")
    if not c or name not in c:
        return None
    return c[name]["total"]


def train_mfu_pct(ctx):
    """Model operations of the window's steps (`train_flops`, the held rows
    from the port's counter) over the window at the bf16 peak."""
    rows = counter(ctx, "moe.held_rows")
    if rows is None or not ctx["steps"] or ctx["window_s"] <= 0:
        return None
    s = ctx["shape"]
    flops = train_flops(s, rows / ctx["steps"])
    return 100.0 * ctx["steps"] * flops / (
        ctx["window_s"] * roofline.PEAK_FLOPS[s["dtype"]])


def moe_imbalance(ctx):
    """Rows of the busiest held expert over the held experts' mean, summed
    over the window's MoE calls (1 is even)."""
    rows = counter(ctx, "moe.held_rows")
    peak = counter(ctx, "moe.held_peak_rows")
    if not rows or peak is None:
        return None
    return peak / (rows / ctx["shape"]["held"])
