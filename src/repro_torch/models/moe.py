"""Mixture-of-Experts FFN (mirrors `repro.models.moe`, its local path):
token-choice top-k routing with a fixed capacity per expert, sort-based
dispatch into an (E, C, D) buffer, one batched product per expert weight.

The reference runs MoE in jnp, not in Pallas, so torch ops carry it here:
a stable `argsort` and `bincount` give every (token, choice) its slot, a
scatter fills the capacity buffer, `torch.bmm` runs the experts.  Two
choices are made for repeatable training on the card:

- each token is read through ``expand`` (not an index gather), so its
  gradient is a sum over the k choices in a fixed order;
- the k choices of a token are combined by a gather to (T, k, D) and a sum
  over k, not by an ``index_add_`` whose atomics would sum in any order.

Router-logit ties go to the lower expert id (a stable descending sort), as
`lax.top_k` breaks them.  The router is an f32 leaf in a bf16 model, as
in the reference.  ``moe_shard_map`` without a mesh is the local path, as
there; the all-to-all path is not ported.

``moe_ffn.dropped`` / ``moe_ffn.routed`` count the (token, choice) slots
dropped at capacity and routed, summed over calls (device tensors, reset
by assigning 0)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, dense_init_, dtype_of, mlp, param


class MoE(nn.Module):
    """Parameters of one MoE FFN, named as the reference's ``moe`` leaves."""

    def __init__(self, cfg, device):
        super().__init__()
        E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
        dt = dtype_of(cfg)
        self.router = param((D, E), torch.float32, device)
        self.w_gate = param((E, D, Fd), dt, device)
        self.w_up = param((E, D, Fd), dt, device)
        self.w_down = param((E, Fd, D), dt, device)
        if cfg.n_shared_experts:
            self.shared = MLP(D, cfg.n_shared_experts * Fd, dt, device)

    def init_(self, generator):
        for w in (self.router, self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)
        if hasattr(self, "shared"):
            self.shared.init_(generator)


def capacity(T: int, k: int, E: int, cf: float) -> int:
    """Slots per expert (`_capacity`): ceil(T k / E cf), at least 8 and at
    most T."""
    c = int(math.ceil(T * k / E * cf))
    return max(8, min(c, T))


def dispatch_indices(flat_e, E: int, C: int):
    """flat_e: (N,) expert id of each (token, choice).  Returns (slot, keep):
    slot in [0, E C], E C for a dropped choice; a choice keeps its place
    when fewer than C earlier choices (in token order) chose its expert."""
    N = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N, device=flat_e.device) - offsets[se]
    keep_sorted = rank < C
    slot_sorted = torch.where(keep_sorted, se * C + rank,
                              torch.full_like(se, E * C))
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(0, order, keep_sorted)
    return slot, keep


def route(p: MoE, cfg, tokens):
    """tokens: (T, D) -> (gates (T, k) f32, idx (T, k) int64, aux): the
    softmax over the k best logits, and the Switch load-balance loss."""
    logits = tokens.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.experts_top_k
    gates = torch.softmax(vals[:, :k], dim=-1)
    idx = idx[:, :k]
    E = cfg.n_experts
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], E).float().mean(0)
    return gates, idx, E * torch.sum(me * ce)


def expert_mm(p: MoE, buffer):
    """buffer: (E, C, D) -> (E, C, D), SwiGLU per expert."""
    g = torch.bmm(buffer, p.w_gate)
    u = torch.bmm(buffer, p.w_up)
    return torch.bmm(F.silu(g) * u, p.w_down)


def moe_local(p: MoE, cfg, tokens, C: int):
    """Capacity-dispatch MoE over a flat (T, D) token array."""
    T, D = tokens.shape
    E, k = cfg.n_experts, cfg.experts_top_k
    gates, idx, aux = route(p, cfg, tokens)
    slot, keep = dispatch_indices(idx.reshape(-1), E, C)
    # row E C takes every dropped choice and is cut off before the experts
    src = tokens[:, None, :].expand(T, k, D).reshape(T * k, D)
    buffer = tokens.new_zeros((E * C + 1, D)).index_put((slot,), src)
    out = expert_mm(p, buffer[:E * C].reshape(E, C, D)).reshape(E * C, D)
    flat_out = torch.cat([out, out.new_zeros((1, D))], 0)
    w = (gates.reshape(-1, 1) * keep[:, None]).to(out.dtype)
    y = (flat_out[slot] * w).to(tokens.dtype).reshape(T, k, D).sum(1)
    moe_ffn.dropped = moe_ffn.dropped + (~keep).sum()
    moe_ffn.routed = moe_ffn.routed + T * k
    return y, aux


def moe_ffn(p: MoE, cfg, x):
    """x: (B, S, D) -> (y, aux_loss), shared experts added."""
    B, S, D = x.shape
    tokens = x.reshape(-1, D)
    C = capacity(tokens.shape[0], cfg.experts_top_k, cfg.n_experts,
                 cfg.capacity_factor)
    y, aux = moe_local(p, cfg, tokens, C)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp(p.shared, x)
    return y, aux


moe_ffn.dropped = 0
moe_ffn.routed = 0
