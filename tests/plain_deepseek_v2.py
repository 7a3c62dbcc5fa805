"""Plain reference of ``deepseek-v2-236b`` training on one expert-parallel
rank: the decoder in float32 PyTorch (TF32 off), its next-token loss with
the per-sequence balance loss, its gradient by autograd and the AdamW
step, imported by nothing of the port and importing none of its kernels.

The configuration is a dict of DeepSeek-V2's published ``config.json``
keys (arXiv:2405.04434; its cut: ``n_routed_experts`` the experts held,
``published["n_routed_experts"]`` the router's width,
``deployment["first_expert"]`` the first held id).

- Model: token embedding; ``first_k_dense_replace`` leading layers of
  MLA + a SwiGLU MLP of ``intermediate_size``, then layers of MLA + MoE;
  a final RMSNorm; an untied LM head.  Every block is pre-norm and
  recomputed in the backward pass (checkpointed), which changes no
  number.  RMSNorm: x rsqrt(mean(x^2) + eps) scale.
- MLA, with d the hidden size, H heads, nd / rd / vd the no-RoPE, RoPE and
  value head dims, r the KV latent and qr the query latent:

      q = rmsnorm(x W_dq) W_uq, H heads of [q_nope (nd), q_rope (rd)]
      [c (r), k_rope (rd)] = x W_dkv;  c = rmsnorm(c)
      k_nope = c W_uk, v = c W_uv (H heads of nd and vd)
      q_rope, k_rope = RoPE(q_rope), RoPE(k_rope)   (k_rope one head, shared)
      s = (q_nope . k_nope + q_rope . k_rope) scale, causal;  o = softmax(s) v
      out = o W_o

  computed in blocks of `HEAD_BLOCK` heads, each checkpointed, so that the
  scores of one block live at a time.
- RoPE: half-split pairs (dim i with dim i + rd / 2).  DeepSeek's code
  rotates interleaved pairs after permuting them to this layout, so the
  two agree up to a fixed permutation of the rd RoPE columns of W_uq and
  W_dkv.  YaRN (``rope_scaling`` type yarn, DeepSeek-V2's
  ``DeepseekV2YarnRotaryEmbedding``), for pair i of rd / 2:

      freq_extra_i = theta^(-2i / rd),  freq_inter_i = freq_extra_i / factor
      d(b) = rd ln(L0 / (2 pi b)) / (2 ln theta)   (L0 the original length)
      lo = max(floor(d(beta_fast)), 0),  hi = min(ceil(d(beta_slow)), rd - 1)
      mask_i = 1 - clamp((i - lo) / (hi - lo), 0, 1)
      inv_freq_i = freq_inter_i (1 - mask_i) + freq_extra_i mask_i
      cos, sin times m(factor, mscale) / m(factor, mscale_all_dim),
      m(f, a) = 0.1 a ln f + 1
      scale = m(factor, mscale_all_dim)^2 / sqrt(nd + rd)

  (DeepSeek-V2: factor 40, mscale = mscale_all_dim = 0.707, so cos and sin
  are unscaled and scale = 1.2608^2 / sqrt(192) = 0.11472).
- MoE (``topk_method`` group_limited_greedy, ``scoring_func`` softmax):
  s = softmax(x W_r) over all router experts in f32; the best
  ``topk_group`` of ``n_group`` groups by their largest s; the top
  ``num_experts_per_tok`` of s over their experts (ties to the lower id);
  gates = s x ``routed_scaling_factor`` (``norm_topk_prob`` false).  This
  rank computes its held experts, SwiGLU of ``moe_intermediate_size``, for
  the choices that reached them, and adds ``n_shared_experts`` shared
  experts (one SwiGLU of n_shared x ``moe_intermediate_size``).  Balance
  loss (``seq_aux``): the mean over sequences of sum_e f_e P_e, f_e = the
  sequence's choices of e times E / (S k), P_e the sequence's mean of s_e;
  the loss adds ``aux_loss_alpha`` times its sum over the MoE layers.  The
  device-level and communication balance losses of the paper are not in
  the published modeling code and are left out.
- Loss: the mean over every position of the negative log-likelihood of
  the next token, plus the balance term.  `loss` returns (total, nll).
- AdamW as the configuration states it: the gradient clipped to global
  norm ``clip_norm``; m and v with bias correction; decoupled weight decay
  on the weights; the learning rate warm for ``warmup_steps`` and then on
  a cosine to ``min_lr_ratio`` over ``total_steps``.

The router's product stays in f32 in every precision: the configuration
states it so (the control lowers only the bf16 products).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import plain

#: heads a block of the attention computes at once
HEAD_BLOCK = 8


def _held(c: dict):
    """(router experts E, first held id, held count)."""
    return (c["published"]["n_routed_experts"],
            c["deployment"]["first_expert"], c["n_routed_experts"])


def lm_specs(c: dict):
    """Every leaf, named as the port names its parameters, in (in, out)
    layout: (name, shape, std), std None for a norm's scale."""
    d, V, H = c["hidden_size"], c["vocab_size"], c["num_attention_heads"]
    r, qr = c["kv_lora_rank"], c["q_lora_rank"]
    nd, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    f, ff = c["moe_intermediate_size"], c["intermediate_size"]
    E, _, n = _held(c)
    fs = c["n_shared_experts"] * f
    specs = [("embed", (V, d), 1.0),
             ("lm_head", (d, V), 1 / math.sqrt(d)),
             ("final_norm.scale", (d,), None)]
    for i in range(c["num_hidden_layers"]):
        p = f"blocks.{i}"
        specs += [(f"{p}.norm1.scale", (d,), None),
                  (f"{p}.attn.w_dkv", (d, r + rd), 1 / math.sqrt(d)),
                  (f"{p}.attn.kv_norm.scale", (r,), None),
                  (f"{p}.attn.w_uk", (r, H * nd), 1 / math.sqrt(r)),
                  (f"{p}.attn.w_uv", (r, H * vd), 1 / math.sqrt(r)),
                  (f"{p}.attn.wo", (H * vd, d), 1 / math.sqrt(H * vd)),
                  (f"{p}.attn.w_dq", (d, qr), 1 / math.sqrt(d)),
                  (f"{p}.attn.q_norm.scale", (qr,), None),
                  (f"{p}.attn.w_uq", (qr, H * (nd + rd)), 1 / math.sqrt(qr)),
                  (f"{p}.norm2.scale", (d,), None)]
        if i < c["first_k_dense_replace"]:
            specs += [(f"{p}.mlp.w_gate", (d, ff), 1 / math.sqrt(d)),
                      (f"{p}.mlp.w_up", (d, ff), 1 / math.sqrt(d)),
                      (f"{p}.mlp.w_down", (ff, d), 1 / math.sqrt(ff))]
        else:
            specs += [(f"{p}.moe.router", (d, E), 1 / math.sqrt(d)),
                      (f"{p}.moe.w_gate", (n, d, f), 1 / math.sqrt(d)),
                      (f"{p}.moe.w_up", (n, d, f), 1 / math.sqrt(d)),
                      (f"{p}.moe.w_down", (n, f, d), 1 / math.sqrt(f)),
                      (f"{p}.moe.shared.w_gate", (d, fs), 1 / math.sqrt(d)),
                      (f"{p}.moe.shared.w_up", (d, fs), 1 / math.sqrt(d)),
                      (f"{p}.moe.shared.w_down", (fs, d), 1 / math.sqrt(fs))]
    return specs


# ---------------------------------------------------------------------------
# RoPE with YaRN
# ---------------------------------------------------------------------------

def _m(factor, a):
    return 0.1 * a * math.log(factor) + 1.0 if factor > 1 else 1.0


def rope_tables(c: dict):
    """(inv_freq (rd / 2,) f32, the factor on cos and sin, softmax scale)."""
    rd, theta = c["qk_rope_head_dim"], float(c["rope_theta"])
    i = torch.arange(0, rd, 2, dtype=torch.float32)
    extra = 1.0 / theta ** (i / rd)
    scale = 1.0 / math.sqrt(c["qk_nope_head_dim"] + rd)
    s = c.get("rope_scaling")
    if not s:
        return extra, 1.0, scale
    assert s["type"] == "yarn", s
    factor = float(s["factor"])
    L0 = float(s["original_max_position_embeddings"])

    def dim_of(b):
        return rd * math.log(L0 / (b * 2 * math.pi)) / (2 * math.log(theta))
    lo = max(math.floor(dim_of(s["beta_fast"])), 0)
    hi = min(math.ceil(dim_of(s["beta_slow"])), rd - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(rd // 2, dtype=torch.float32) - lo)
            / (hi - lo)).clamp(0, 1)
    mask = 1 - ramp
    inter = 1.0 / (factor * theta ** (i / rd))
    inv = inter * (1 - mask) + extra * mask
    mult = _m(factor, s.get("mscale", 1.0)) / _m(factor,
                                                  s.get("mscale_all_dim", 0.0))
    if s.get("mscale_all_dim"):
        scale *= _m(factor, s["mscale_all_dim"]) ** 2
    return inv, mult, scale


def rope(x, positions, inv, mult):
    """x (B, S, n, rd), half-split pairs."""
    half = x.shape[-1] // 2
    ang = positions[:, :, None].float() * inv.to(x.device)
    sin = (torch.sin(ang) * mult)[:, :, None]
    cos = (torch.cos(ang) * mult)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _attend_heads(qn, qr, kn, kr, v, scale, pr):
    """Causal attention of a block of heads: qn / kn (B, S, h, nd), qr
    (B, S, h, rd), kr (B, S, rd) shared, v (B, S, h, vd)."""
    S = qn.shape[1]
    s = (pr.einsum("bqhd,bkhd->bhqk", qn, kn)
         + pr.einsum("bqhd,bkd->bhqk", qr, kr)) * scale
    i = torch.arange(S, device=qn.device)
    s = s.masked_fill(~(i[:, None] >= i[None, :]), float("-inf"))
    return pr.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def mla(x, w, p, positions, c, pr, tables):
    B, S, d = x.shape
    H = c["num_attention_heads"]
    r = c["kv_lora_rank"]
    nd, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    eps = c["rms_norm_eps"]
    inv, mult, scale = tables
    q = pr.mm(plain.rmsnorm(pr.mm(x, w[f"{p}.attn.w_dq"]),
                            w[f"{p}.attn.q_norm.scale"], eps),
              w[f"{p}.attn.w_uq"]).view(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], rope(q[..., nd:], positions, inv, mult)
    ckv = pr.mm(x, w[f"{p}.attn.w_dkv"])
    lat = plain.rmsnorm(ckv[..., :r], w[f"{p}.attn.kv_norm.scale"], eps)
    k_rope = rope(ckv[..., None, r:], positions, inv, mult)[:, :, 0]
    k_nope = pr.mm(lat, w[f"{p}.attn.w_uk"]).view(B, S, H, nd)
    v = pr.mm(lat, w[f"{p}.attn.w_uv"]).view(B, S, H, vd)
    outs = []
    for h0 in range(0, H, HEAD_BLOCK):
        sl = slice(h0, h0 + HEAD_BLOCK)
        outs.append(checkpoint(_attend_heads, q_nope[:, :, sl],
                               q_rope[:, :, sl], k_nope[:, :, sl], k_rope,
                               v[:, :, sl], scale, pr, use_reentrant=False))
    o = torch.cat(outs, dim=2).reshape(B, S, H * vd)
    return pr.mm(o, w[f"{p}.attn.wo"])


def swiglu(x, wg, wu, wd, pr):
    return pr.mm(F.silu(pr.mm(x, wg)) * pr.mm(x, wu), wd)


def route(tokens, router, c, batch):
    """(gates (T, k), idx (T, k), balance loss) of the group-limited greedy
    router, in f32."""
    T = tokens.shape[0]
    E = router.shape[1]
    k, G, kg = (c["num_experts_per_tok"], c["n_group"], c["topk_group"])
    scores = torch.softmax(tokens @ router, dim=-1)
    best = scores.view(T, G, E // G).amax(-1)
    order = torch.sort(best, dim=-1, descending=True, stable=True)[1]
    keep = torch.zeros((T, G), dtype=torch.bool, device=tokens.device)
    keep[torch.arange(T, device=tokens.device)[:, None], order[:, :kg]] = True
    masked = torch.where(keep.repeat_interleave(E // G, dim=1), scores,
                         torch.zeros_like(scores))
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    gates = vals[:, :k] * c["routed_scaling_factor"]
    idx = idx[:, :k]
    S = T // batch
    f = torch.zeros((batch, E), device=tokens.device)
    f = f.scatter_add(1, idx.reshape(batch, S * k),
                      torch.ones((batch, S * k), device=tokens.device))
    f = f * (E / (S * k))
    aux = (f * scores.view(batch, S, E).mean(1)).sum(1).mean()
    return gates, idx, aux


def moe(x, w, p, c, pr, record):
    """The held experts' share of the layer plus the shared experts;
    returns (y, balance loss)."""
    B, S, d = x.shape
    T = B * S
    tokens = x.reshape(T, d)
    _, first, n = _held(c)
    k = c["num_experts_per_tok"]
    gates, idx, aux = route(tokens, w[f"{p}.moe.router"], c, B)
    if record is not None and torch._C._current_graph_task_id() == -1:
        record.append(idx.detach().cpu())
    flat = idx.reshape(-1)
    gflat = gates.reshape(-1)
    rows, vals = [], []
    for e in range(n):
        sel = torch.nonzero(flat == first + e)[:, 0]
        if sel.numel() == 0:
            continue
        xe = tokens[sel // k]
        ye = swiglu(xe, w[f"{p}.moe.w_gate"][e], w[f"{p}.moe.w_up"][e],
                    w[f"{p}.moe.w_down"][e], pr)
        rows.append(sel)
        vals.append(ye * gflat[sel, None])
    out = tokens.new_zeros((T * k, d))
    if rows:
        out = out.index_put((torch.cat(rows),), torch.cat(vals))
    y = out.view(T, k, d).sum(1)
    y = y + swiglu(tokens, w[f"{p}.moe.shared.w_gate"],
                   w[f"{p}.moe.shared.w_up"], w[f"{p}.moe.shared.w_down"], pr)
    return y.view(B, S, d), aux


def block(x, w, i, positions, c, pr, tables, record):
    """One pre-norm layer: x + mla(norm1 x), then + ffn(norm2 x); returns
    (x, balance loss or 0)."""
    p = f"blocks.{i}"
    eps = c["rms_norm_eps"]
    x = x + mla(plain.rmsnorm(x, w[f"{p}.norm1.scale"], eps), w, p,
                positions, c, pr, tables)
    h = plain.rmsnorm(x, w[f"{p}.norm2.scale"], eps)
    if i < c["first_k_dense_replace"]:
        return x + swiglu(h, w[f"{p}.mlp.w_gate"], w[f"{p}.mlp.w_up"],
                          w[f"{p}.mlp.w_down"], pr), x.new_zeros(())
    y, aux = moe(h, w, p, c, pr, record)
    return x + y, aux


def loss(w: dict, c: dict, tokens, labels, pr: plain.Precision,
         record=None):
    """(total, nll): the next-token NLL plus ``aux_loss_alpha`` times the
    summed balance losses, and the NLL alone.  ``record``: a list that
    takes each MoE layer's expert choices (T, k) of the forward pass."""
    tables = rope_tables(c)
    x = w["embed"][tokens]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    aux = x.new_zeros(())
    for i in range(c["num_hidden_layers"]):
        x, a = checkpoint(block, x, w, i, pos, c, pr, tables, record,
                          use_reentrant=False)
        aux = aux + a
    x = plain.rmsnorm(x, w["final_norm.scale"], c["rms_norm_eps"])
    logits = pr.mm(x, w["lm_head"])
    valid = labels >= 0
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.clamp_min(0).reshape(-1),
                          reduction="none").reshape(labels.shape)
    nll = torch.where(valid, nll, torch.zeros_like(nll)).sum() \
        / valid.sum().clamp_min(1)
    return nll + c["aux_loss_alpha"] * aux, nll


def lr_at(o: dict, step: int) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return o["lr"] * warm * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * cos)


class AdamW:
    def __init__(self, params: dict, o: dict):
        self.o = o
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """One update in place; returns each leaf's clipped gradient
        norm."""
        o = self.o
        self.t += 1
        gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                              for g in grads.values()))
        scale = min(o["clip_norm"] / (gnorm + 1e-9), 1.0)
        lr = lr_at(o, self.t)
        bc1 = 1 - o["b1"] ** self.t
        bc2 = 1 - o["b2"] ** self.t
        norms = {}
        for n, p in params.items():
            g = grads[n] * scale
            norms[n] = float(g.norm())
            self.m[n].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.v[n].mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
            upd = (self.m[n] / bc1) / ((self.v[n] / bc2).sqrt() + o["eps"])
            p.sub_(lr * (upd + o["weight_decay"] * p))
        return norms
