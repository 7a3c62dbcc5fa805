"""Shared arithmetic of the per-layer readers.  Each reader returns None
where the run gave it nothing to read (no trace, no such kernel, no such
span), and never 0 for a share of a roofline or a peak."""
from __future__ import annotations

from bench import roofline
from bench.profiling import kernel_time

#: substrings of kernel 1's kernels (`kernels/knn_topk/kernel.cu`)
KNN_TOPK = ("knn_scan_kernel", "knn_refine_kernel", "knn_compact_kernel")
#: kernel 2's forward and kernel 2b's launches (`kernels/flash_attention`)
FLASH_FWD = ("flash_fwd_kernel",)
FLASH_BWD = ("flash_bwd_",)
FLASH_BWD_MAIN = ("flash_bwd_kernel",)


def span_mean_ms(ctx, name):
    return ctx["spans"].mean_ms(name)


def device_idle_pct(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["n_device_ops"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def knn_topk_roofline_pct(ctx):
    """Kernel 1's least time by the waves' shapes over its device time."""
    tr = ctx.get("trace")
    if not tr:
        return None
    t, launches = kernel_time(tr, *KNN_TOPK)
    waves = [q for q in ctx["wave_q"] if q]
    if t <= 0 or not waves:
        return None
    cfg = ctx["cfg"]
    N, D, k = ctx["support_rows"], cfg["embed_dim"], cfg["k"]
    least = 0.0
    for q in waves:
        flops, nbytes = roofline.knn_topk_cost(q, N, D, k)
        least += roofline.bound(nbytes, flops, "float32")[0]
    # a profiler that lost launches lost their time too: scale by the
    # share of waves whose launch it recorded (one launch a call at k <= 128)
    calls = _calls_traced(tr, KNN_TOPK[0], len(waves))
    return 100.0 * least * calls / len(waves) / t


def _calls_traced(tr, main, expected):
    _, n = kernel_time(tr, main)
    return min(n, expected) if n else expected


def route_mfu_pct(ctx):
    """Model operations of the window's waves (the encoder at every
    position, and 2 Q N D of retrieval) over the window at the f32 peak."""
    waves = [q for q in ctx["wave_q"] if q]
    if not waves or ctx["window_s"] <= 0:
        return None
    cfg = ctx["cfg"]
    e = cfg["encoder"]
    N, D, k = ctx["support_rows"], cfg["embed_dim"], cfg["k"]
    flops = sum(roofline.encoder_flops(
        q, e["max_positions"], e["num_hidden_layers"], e["hidden_size"],
        e["num_attention_heads"], e["head_dim"], e["intermediate_size"])
        + roofline.knn_topk_cost(q, N, D, k)[0] for q in waves)
    return 100.0 * flops / (ctx["window_s"] * roofline.PEAK_FLOPS_F32)


def flash_roofline_pct(ctx, backward):
    """Kernel 2's (or 2b's) least time a call by the step's shapes, times
    its calls in the trace, over the device time of the kernels so
    named."""
    tr = ctx.get("trace")
    if not tr:
        return None
    names = FLASH_BWD if backward else FLASH_FWD
    main = FLASH_BWD_MAIN if backward else FLASH_FWD
    t, _ = kernel_time(tr, *names)
    _, calls = kernel_time(tr, *main)
    if t <= 0 or calls == 0:
        return None
    s = ctx["shape"]
    cost = roofline.flash_bwd_cost if backward else roofline.flash_fwd_cost
    flops, nbytes = cost(s["B"], s["S"], s["S"], s["H"], s["KV"], s["hd"],
                         s["elt"], True, s["window"])
    least = roofline.bound(nbytes, flops, s["dtype"])[0]
    return 100.0 * least * calls / t


def train_mfu_pct(ctx):
    """Model operations of the window's steps over the window at the bf16
    peak."""
    s = ctx["shape"]
    if not ctx["steps"] or ctx["window_s"] <= 0:
        return None
    flops = roofline.lm_train_flops(s["B"], s["S"], s["layers"], s["d"],
                                    s["H"], s["KV"], s["hd"], s["d_ff"],
                                    s["vocab"], s["window"])
    return 100.0 * ctx["steps"] * flops / (
        ctx["window_s"] * roofline.PEAK_FLOPS[s["dtype"]])
