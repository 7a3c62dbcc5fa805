"""The bf16 forward kernel's arithmetic (kernel 2 on the tensor cores,
`flash_fwd_kernel_tc` in `kernels/flash_attention/kernel.cu`) emulated in
plain torch on the CPU and held against the f32 plain version.

The emulation (`_emulate_tc_forward`) follows the kernel: S from the
bf16 inputs summed in f32, the online softmax over 64-key tiles in the
log2 domain, P = exp2(S c log2(e) - m) in f32 entering P.V as two bf16
terms hi = bf16(p) and lo = bf16(p - hi), f32 sums; it returns the bf16
output, the f32 output before its rounding (`o32`, which kernel 2b's D
reads) and the natural-log log-sum-exp (+inf for a row with no live key,
whose output is 0).

Limits against the f32 plain version on the same bf16 values: the bf16
output within the card's bf16 limit (1e-2, or bf16's own rounding 2^-8
|ref| + 2e-5 where larger: chip_smoke.py's `attn_err`); `o32` within
2e-5 + 2^-14 |ref|, which one bf16 rounding of P (FlashAttention-2's
products) leaves; lse within 1e-5 + 1e-6 |lse| of the float64 one."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_reference)

BK = 64
LOG2E = 1.4426950408889634


def _live(Sq, Sk, causal, window, k0=0, k1=None):
    i = torch.arange(Sq)[:, None]
    j = torch.arange(k0, Sk if k1 is None else k1)[None, :]
    ok = torch.ones(Sq, j.shape[1], dtype=torch.bool)
    if causal:
        ok &= j <= i
    if window:
        ok &= i - j < window
    return ok


def _emulate_tc_forward(q, k, v, causal, window, split=True):
    """(o bf16 (B, Sq, H, hd), o32 f32 (B, Sq, H, hd), lse f32 (B, H, Sq))
    as the bf16 kernel computes them; ``split`` False rounds P to bf16
    once."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    scale2 = torch.tensor(1.0 / math.sqrt(hd) * LOG2E, dtype=torch.float32)
    m = torch.full((B, KV, G, Sq), -math.inf)
    l = torch.zeros(B, KV, G, Sq)
    acc = torch.zeros(B, KV, G, Sq, hd)
    for k0 in range(0, Sk, BK):
        k1 = min(k0 + BK, Sk)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, k0:k1])
        s = s.masked_fill(~_live(Sq, Sk, causal, window, k0, k1), -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * scale2)
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s * scale2 - m_use[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        pv = torch.einsum("bkgqs,bskd->bkgqd", hi, vf[:, k0:k1])
        if split:
            lo = (p - hi).bfloat16().float()
            pv = torch.einsum("bkgqs,bskd->bkgqd", lo, vf[:, k0:k1]) + pv
        acc = acc * alpha[..., None] + pv
        m = m_new
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    o32 = (acc * inv[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    lse = torch.where(l > 0, (m + torch.log2(l)) * math.log(2.0), math.inf)
    return o32.bfloat16(), o32, lse.reshape(B, H, Sq)


def _inputs(B, Sq, Sk, KV, G, hd, seed):
    rng = np.random.default_rng(seed)
    H = KV * G
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(t).bfloat16() for t in (q, k, v)]


def _plain(q, k, v, causal, window):
    """The f32 plain output and the float64 log-sum-exp (B, H, Sq) of the
    scaled scores, on the same bf16 values."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    out = flash_attention_reference(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     q.double().reshape(B, Sq, KV, H // KV, hd),
                     k.double()) / math.sqrt(hd)
    s = s.masked_fill(~_live(Sq, k.shape[1], causal, window), -math.inf)
    return out, torch.logsumexp(s, -1).reshape(B, H, Sq)


def _ratios(q, k, v, causal, window, split=True):
    """Largest error over its limit of o, o32 and lse on the rows with a
    live key; the rows without one must read o32 0 and lse +inf."""
    o, o32, lse = _emulate_tc_forward(q, k, v, causal, window, split)
    ref, ref_lse = _plain(q, k, v, causal, window)
    rows = _live(q.shape[1], k.shape[1], causal, window).any(-1)
    assert torch.equal(o32[:, ~rows], torch.zeros_like(o32[:, ~rows]))
    assert torch.all(lse[..., ~rows] == math.inf)
    o, o32, ref = o[:, rows].float(), o32[:, rows], ref[:, rows]
    lse, ref_lse = lse[..., rows].double(), ref_lse[..., rows]
    bf16_lim = torch.maximum(torch.full_like(ref, 1e-2),
                             ref.abs() * 2.0 ** -8 + 2e-5)
    return (float(((o - ref).abs() / bf16_lim).max()),
            float(((o32 - ref).abs() / (2e-5 + 2.0 ** -14 * ref.abs())).max()),
            float(((lse - ref_lse).abs() / (1e-5 + 1e-6 * ref_lse.abs())).max()))


#: (B, Sq, Sk, KV, G, hd, causal, window): danube's GQA at hd 80 over 17 key
#: tiles; each head dim under causal, windowed (window < S, not a multiple
#: of 64) and full masks; S not a multiple of 64; seamless's cross attention
#: (Sq != Sk, no mask) down to Sq 1; a window that leaves rows with no
#: live key (Sq > Sk)
CASES = [
    (1, 1030, 1030, 2, 4, 80, True, 0),
    (2, 130, 130, 2, 1, 64, True, 0),
    (1, 200, 200, 1, 5, 64, True, 48),
    (1, 333, 333, 1, 4, 80, True, 100),
    (1, 100, 100, 2, 1, 112, False, 0),
    (1, 150, 150, 2, 2, 112, True, 0),
    (1, 257, 257, 1, 12, 128, True, 64),
    (1, 200, 200, 2, 3, 128, False, 0),
    (2, 96, 40, 4, 1, 64, False, 0),
    (2, 1, 150, 4, 1, 64, False, 0),
    (1, 200, 40, 2, 2, 80, True, 16),
]


@pytest.mark.parametrize("B,Sq,Sk,KV,G,hd,causal,window", CASES)
def test_tc_forward_emulation_within_limits(B, Sq, Sk, KV, G, hd, causal,
                                            window):
    """The bf16 kernel's arithmetic against the f32 plain version: o within
    the card's bf16 limit, o32 and lse within their f32 limits."""
    q, k, v = _inputs(B, Sq, Sk, KV, G, hd, seed=Sq + Sk + hd + G)
    ratios = _ratios(q, k, v, causal, window)
    assert max(ratios) <= 1.0, ratios


def test_one_bf16_rounding_of_p_misses_the_o32_limit():
    """Why P enters P.V as two bf16 terms: rounded once (FlashAttention-2's
    bf16 P), o32, which kernel 2b's D = rowsum(dO o O) reads, leaves its
    limit at danube's hd 80, while the split stays well inside it."""
    q, k, v = _inputs(1, 1030, 1030, 2, 4, 80, seed=2194)
    once = _ratios(q, k, v, True, 0, split=False)
    split = _ratios(q, k, v, True, 0)
    assert once[1] > 10.0 and split[1] <= 0.5, (once, split)
