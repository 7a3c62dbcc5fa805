"""Plain PyTorch pieces the references are built of: weights made from a
seed, RMSNorm, half-split RoPE, grouped-query attention with causal and
sliding-window masks, SwiGLU, all computed in float32 with TF32 off.

Every matrix product goes through `Precision.mm`, which is where a
reference is put into a lower precision for the control of a comparison:
``"tf32"`` rounds both inputs of every product to TF32 (10 explicit
mantissa bits, round to nearest even), as a TF32 tensor-core product
reads them; ``"fp8"`` scales each input to the e4m3 range by its largest
magnitude and rounds it to float8 e4m3, as a per-tensor-scaled fp8
product reads it.  The gradient passes the rounding straight through.
Imports nothing of the port."""
from __future__ import annotations

import math

import torch


def no_tf32():
    """A reference never computes in TF32 by accident."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    b = x.float().contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 (max 448) and back, as float32."""
    xf = x.float()
    amax = xf.abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    return (xf * scale).to(torch.float8_e4m3fn).float() / scale


class _Straight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Precision:
    """The precision every product of a reference is computed in."""

    ROUND = {"f32": None, "tf32": round_tf32, "fp8": round_fp8}

    def __init__(self, name: str = "f32"):
        if name not in self.ROUND:
            raise ValueError(f"precision {name!r} not in {list(self.ROUND)}")
        self.name = name
        self._round = self.ROUND[name]

    def cast(self, x):
        if self._round is None:
            return x
        if x.requires_grad:
            return _Straight.apply(x, self._round)
        return self._round(x)

    def mm(self, a, b):
        return self.cast(a) @ self.cast(b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.cast(a), self.cast(b))


# ---------------------------------------------------------------------------
# weights from a seed
# ---------------------------------------------------------------------------

def make_weights(specs, generator, device, dtype=torch.float32):
    """``specs``: [(name, shape, std)], std None for a norm's scale (ones).
    Every other leaf is a uniform draw of unit variance times its std, all
    drawn in ONE call into one flat buffer of ``dtype`` on ``device``;
    returns {name: view into that buffer}."""
    sizes = [math.prod(s) for _, s, _ in specs]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    flat.uniform_(-math.sqrt(3.0), math.sqrt(3.0), generator=generator)
    out, off = {}, 0
    for (name, shape, std), n in zip(specs, sizes):
        w = flat[off:off + n].view(shape)
        if std is None:
            w.fill_(1.0)
        else:
            w.mul_(std)
        out[name] = w
        off += n
    return out


def block_specs(prefix, d, H, KV, hd, d_ff):
    """Leaves of one pre-norm attention + SwiGLU block, named as the
    port names its parameters, in (in, out) layout."""
    return [(f"{prefix}.norm1.scale", (d,), None),
            (f"{prefix}.attn.wq", (d, H * hd), 1 / math.sqrt(d)),
            (f"{prefix}.attn.wk", (d, KV * hd), 1 / math.sqrt(d)),
            (f"{prefix}.attn.wv", (d, KV * hd), 1 / math.sqrt(d)),
            (f"{prefix}.attn.wo", (H * hd, d), 1 / math.sqrt(H * hd)),
            (f"{prefix}.norm2.scale", (d,), None),
            (f"{prefix}.mlp.w_gate", (d, d_ff), 1 / math.sqrt(d)),
            (f"{prefix}.mlp.w_up", (d, d_ff), 1 / math.sqrt(d)),
            (f"{prefix}.mlp.w_down", (d_ff, d), 1 / math.sqrt(d_ff))]


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x (B, S, H, hd), half-split pairs (dim i with dim i + hd / 2)."""
    hd = x.shape[-1]
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = positions[:, :, None].float() * inv               # (B, S, half)
    sin, cos = torch.sin(ang)[:, :, None], torch.cos(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, pr: Precision, *, causal=True, window=0):
    """q (B, S, H, hd), k / v (B, S, KV, hd): softmax(q k^T / sqrt(hd))
    over the kept keys (j <= i, and i - j < window where window > 0),
    each KV head shared by H / KV query heads."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    s = pr.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(hd)
    i = torch.arange(S, device=q.device)
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        keep &= i[:, None] >= i[None, :]
    if window:
        keep &= (i[:, None] - i[None, :]) < window
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = pr.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(B, S, H, hd)


def block(x, w, prefix, positions, c: dict, pr: Precision):
    """One pre-norm block: x + attn(norm1 x), then + swiglu(norm2 x).
    ``c``: d, H, KV, hd, eps, theta, window."""
    B, S, d = x.shape
    H, KV, hd = c["H"], c["KV"], c["hd"]
    h = rmsnorm(x, w[f"{prefix}.norm1.scale"], c["eps"])
    q = pr.mm(h, w[f"{prefix}.attn.wq"]).view(B, S, H, hd)
    k = pr.mm(h, w[f"{prefix}.attn.wk"]).view(B, S, KV, hd)
    v = pr.mm(h, w[f"{prefix}.attn.wv"]).view(B, S, KV, hd)
    q = rope(q, positions, c["theta"])
    k = rope(k, positions, c["theta"])
    o = attention(q, k, v, pr, causal=True, window=c["window"])
    x = x + pr.mm(o.reshape(B, S, H * hd), w[f"{prefix}.attn.wo"])
    h = rmsnorm(x, w[f"{prefix}.norm2.scale"], c["eps"])
    g = pr.mm(h, w[f"{prefix}.mlp.w_gate"])
    u = pr.mm(h, w[f"{prefix}.mlp.w_up"])
    return x + pr.mm(torch.nn.functional.silu(g) * u,
                     w[f"{prefix}.mlp.w_down"])
