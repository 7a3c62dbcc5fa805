"""The yardstick's arithmetic: the card's peaks, the least time a piece of
work could take on it, and the operations and bytes of each kernel and step
the benchmark reads, all computed from shapes.

`bound` is a frozen copy of ``chip_smoke.py``'s ``bound()`` with the
constants of ``repro_torch/launch/mesh.py`` written in, so that a later
change to the program cannot move the yardstick.  Peaks are NVIDIA's data
sheet for one H100 SXM at its full 700 W power limit; a card set below it
reads lower against them, so every run records the card's power limit."""
from __future__ import annotations

#: HBM bytes/s
HBM_BW = 3.35e12
#: dense tensor-core peaks, FLOP/s.  f32 is the rate of f32-accurate
#: products on the tensor cores (three TF32 passes a product at 494.7
#: TFLOP/s TF32), the precision the port's f32 kernels compute in
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 494.7e12 / 3
PEAK_FLOPS = {"float32": PEAK_FLOPS_F32, "bfloat16": PEAK_FLOPS_BF16}


def bound(nbytes: float, flops: float, dtype: str):
    """The least seconds the card could take: bytes over its HBM rate or
    operations over the dtype's peak, whichever is larger, and which of
    the two it is."""
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# kernel 1: exact cosine top-k
# ---------------------------------------------------------------------------

def knn_topk_cost(Q: int, N: int, D: int, k: int):
    """(flops, bytes) of one exact top-k call over an f32 support: every
    query against every row, 2 Q N D; the support and queries read once,
    the (score, id) outputs written once at 4 + 4 bytes."""
    return 2.0 * Q * N * D, 4.0 * N * D + 4.0 * Q * D + 8.0 * Q * k


# ---------------------------------------------------------------------------
# kernels 2 and 2b: flash attention forward and backward
# ---------------------------------------------------------------------------

def attended_pairs(Sq: int, Sk: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs a mask keeps: key j for query i when j <= i
    (causal) and i - j < window (window > 0), queries and keys from 0."""
    if not causal:
        return Sq * Sk
    n = 0
    w = window if window > 0 else Sq + Sk
    # query i keeps min(i + 1, w, Sk) keys
    for i in range(Sq):
        n += min(i + 1, w, Sk)
    return n


def flash_fwd_cost(B, Sq, Sk, H, KV, hd, elt, causal=True, window=0):
    """(flops, bytes) of one forward call: QK^T and PV over the kept pairs,
    2 hd operations each; q, k, v read once, o written once, the f32
    log-sum-exp row written once."""
    pairs = attended_pairs(Sq, Sk, causal, window)
    flops = 4.0 * B * H * hd * pairs
    nbytes = elt * B * hd * (2 * Sq * H + 2 * Sk * KV) + 4.0 * B * H * Sq
    return flops, nbytes


def flash_bwd_cost(B, Sq, Sk, H, KV, hd, elt, causal=True, window=0):
    """(flops, bytes) of one backward call: the scores recomputed (QK^T),
    then dV = P^T dO, dP = dO V^T, dQ = dS K and dK = dS^T Q, 2 hd
    operations each over the kept pairs (10 hd a pair); q, k, v, o, dO and
    the log-sum-exp read once, dq, dk, dv written once."""
    pairs = attended_pairs(Sq, Sk, causal, window)
    flops = 10.0 * B * H * hd * pairs
    nbytes = (elt * B * hd * (4 * Sq * H + 4 * Sk * KV)
              + 4.0 * B * H * Sq)
    return flops, nbytes


# ---------------------------------------------------------------------------
# dense decoder blocks: the query encoder and a training step
# ---------------------------------------------------------------------------

def block_matmul_params(d: int, H: int, KV: int, hd: int, d_ff: int) -> int:
    """Weights a token multiplies in one attention + SwiGLU block."""
    return d * H * hd * 2 + d * KV * hd * 2 + 3 * d * d_ff


def encoder_flops(n_texts: int, L: int, layers: int, d: int, H: int,
                  hd: int, d_ff: int) -> float:
    """Forward operations of the query encoder over ``n_texts`` padded to
    ``L`` positions (the encoder runs every position): the block's weight
    products, 2 a weight a position, and causal attention."""
    per_text = layers * (2.0 * L * block_matmul_params(d, H, H, hd, d_ff)
                         + 4.0 * H * hd * attended_pairs(L, L, True))
    return n_texts * per_text


def lm_train_flops(B: int, S: int, layers: int, d: int, H: int, KV: int,
                   hd: int, d_ff: int, vocab: int, window: int = 0) -> float:
    """Model operations of one training step: 6 a matmul weight a token
    (the blocks and the LM head; the embedding is a lookup), plus causal
    attention, 12 hd a kept pair a head (4 forward, 8 backward).  No
    recomputation is counted: a rematerialised forward is work the model
    does not need."""
    tokens = B * S
    weights = layers * block_matmul_params(d, H, KV, hd, d_ff) + d * vocab
    attn = layers * 12.0 * B * H * hd * attended_pairs(S, S, True, window)
    return 6.0 * weights * tokens + attn
