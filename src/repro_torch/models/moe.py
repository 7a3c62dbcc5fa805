"""Mixture-of-Experts FFN (mirrors `repro.models.moe`): token-choice top-k
routing with a fixed capacity per expert, sort-based dispatch into an
(E, C, D) buffer, one batched product per expert weight.

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
in the reference.

Expert parallelism (`moe_shard_map`, the reference's `_moe_shard_map`),
taken when ``cfg.moe_shard_map`` is set, the mesh (``mesh=``; the model
passes `distributed.sharding.active_mesh()`) has a "model" axis of size
m > 1 and m divides E; otherwise the local path runs, as there.  SPMD:
every rank gets the same (B, S, D) input and holds E / m experts (its
"model" coordinate's block; `MoE` built with ``n_local`` and
`init_by_expert_`, or cut by `convert.moe_shard`).  A rank routes its
block of the batch (data axes) and of the sequence ("model" axis) with
the capacity of its LOCAL token count, lays the dispatch buffer out as
(m, E / m, C_l, D), sends each expert group to its owner by one
all-to-all over the "model" sub-group, runs its experts over the rows of
all m sources (grouped by source), and sends them back the same way.
Every rank then gathers the output blocks into the full (B, S, D); aux is
averaged over the mesh.  Forward only (serving): the collectives have no
gradient here.

``moe_ffn.dropped`` / ``moe_ffn.routed`` count the (token, choice) slots
dropped at capacity and routed, summed over calls (device tensors, reset
by assigning 0)."""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import comm
from repro_torch.launch.mesh import axis_size, mesh_group

from .layers import MLP, dense_init_, dtype_of, mlp, param


class MoE(nn.Module):
    """Parameters of one MoE FFN, named as the reference's ``moe`` leaves.
    ``n_local`` experts (default all E): an expert-parallel rank's block."""

    def __init__(self, cfg, device, n_local: int | None = None):
        super().__init__()
        D, Fd = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
        E = cfg.n_experts if n_local is None else n_local
        dt = dtype_of(cfg)
        self.router = param((D, cfg.n_experts), torch.float32, device)
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

    @torch.no_grad()
    def init_by_expert_(self, seed: int, first: int = 0):
        """Seeded init in which expert ``first + j`` (this module's j-th)
        draws from a generator of its own, seeded by (seed, expert id), so
        an expert-parallel rank makes only its experts and they equal the
        full layer's; the router and the shared experts from ``seed``."""
        dev = self.router.device
        g = torch.Generator(device=dev).manual_seed(seed)
        dense_init_(self.router, g)
        if hasattr(self, "shared"):
            self.shared.init_(g)
        for j in range(self.w_gate.shape[0]):
            ge = torch.Generator(device=dev).manual_seed(
                (seed + 1) * 1_000_003 + first + j)
            for w in (self.w_gate, self.w_up, self.w_down):
                dense_init_(w[j], ge)


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


def expert_mm(p, buffer):
    """buffer: (E, C, D) -> (E, C, D), SwiGLU per expert (``p``'s
    ``w_gate`` / ``w_up`` / ``w_down`` of E experts)."""
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
    return _combine(cfg, tokens, out, slot, keep, gates), aux


def _combine(cfg, tokens, out, slot, keep, gates):
    """Expert outputs (E C, D) back to (T, D): each (token, choice) row
    times its gate (0 when dropped), summed over the k choices."""
    T, D = tokens.shape
    k = cfg.experts_top_k
    flat_out = torch.cat([out, out.new_zeros((1, D))], 0)
    w = (gates.reshape(-1, 1) * keep[:, None]).to(out.dtype)
    y = (flat_out[slot] * w).to(tokens.dtype).reshape(T, k, D).sum(1)
    moe_ffn.dropped = moe_ffn.dropped + (~keep).sum()
    moe_ffn.routed = moe_ffn.routed + T * k
    return y


def expert_parallel(cfg, mesh) -> bool:
    """Whether `moe_ffn` takes the expert-parallel path on ``mesh``."""
    m = 0 if mesh is None else axis_size(mesh, "model")
    return bool(cfg.moe_shard_map) and m > 1 and cfg.n_experts % m == 0


def _block(mesh, x):
    """(this rank's (B_l, S_l, D) block of ``x``, B_l, S_l): the batch split
    over the data axes (folded in mesh order), the sequence over "model"."""
    names = list(mesh.mesh_dim_names)
    mi = names.index("model")
    coord = mesh.get_coordinate()
    nd, dr = 1, 0
    for i, size in enumerate(mesh.shape):
        if i != mi:
            nd, dr = nd * size, dr * size + coord[i]
    m, mr = mesh.shape[mi], coord[mi]
    B, S, _ = x.shape
    if B % nd or S % m:
        raise ValueError(f"moe_shard_map: batch {B} and sequence {S} must "
                         f"divide by the data ranks {nd} and the model "
                         f"ranks {m}")
    bl, sl = B // nd, S // m
    return x[dr * bl:(dr + 1) * bl, mr * sl:(mr + 1) * sl], bl, sl


def moe_shard_map(p: MoE, cfg, x, mesh):
    """The expert-parallel forward (module docstring): x (B, S, D), the
    same on every rank -> (y (B, S, D), aux averaged over the mesh)."""
    E, k, D = cfg.n_experts, cfg.experts_top_k, cfg.d_model
    m = axis_size(mesh, "model")
    el = E // m
    mr = mesh.get_coordinate()[list(mesh.mesh_dim_names).index("model")]
    xs, bl, sl = _block(mesh, x)
    tokens = xs.reshape(-1, D)
    tl = tokens.shape[0]
    cl = capacity(tl, k, E, cfg.capacity_factor)
    gates, idx, aux = route(p, cfg, tokens)
    slot, keep = dispatch_indices(idx.reshape(-1), E, cl)
    src = tokens[:, None, :].expand(tl, k, D).reshape(tl * k, D)
    buf = tokens.new_zeros((E * cl + 1, D)).index_put((slot,), src)
    group = mesh["model"].get_group()
    # expert group j to its owner j; recv[j]: source j's rows for my experts
    recv = comm.all_to_all(buf[:E * cl].reshape(m, el, cl, D), group)
    if p.w_gate.shape[0] == E:          # a full layer: this rank's block
        p = SimpleNamespace(**{n: getattr(p, n)[mr * el:(mr + 1) * el]
                               for n in ("w_gate", "w_up", "w_down")})
    out = expert_mm(p, recv.transpose(0, 1).reshape(el, m * cl, D))
    back = comm.all_to_all(
        out.reshape(el, m, cl, D).transpose(0, 1).contiguous(), group)
    y = _combine(cfg, tokens, back.reshape(E * cl, D), slot, keep, gates)
    flat = mesh_group(mesh)
    got = comm.all_gather(y.reshape(bl, sl, D), flat)
    nd = mesh.ndim
    mi = list(mesh.mesh_dim_names).index("model")
    order = [i for i in range(nd) if i != mi] + [nd, mi, nd + 1, nd + 2]
    y = got.reshape(*mesh.shape, bl, sl, D).permute(*order)
    aux = comm.all_reduce_mean(aux.reshape(1).float(), flat)[0]
    return y.reshape(x.shape), aux


def moe_ffn(p: MoE, cfg, x, mesh=None):
    """x: (B, S, D) -> (y, aux_loss), shared experts added; expert-parallel
    over ``mesh`` where `expert_parallel` holds."""
    B, S, D = x.shape
    if expert_parallel(cfg, mesh):
        y, aux = moe_shard_map(p, cfg, x, mesh)
    else:
        if p.w_gate.shape[0] != cfg.n_experts:
            raise ValueError(f"moe_ffn: the local path needs all "
                             f"{cfg.n_experts} experts, this layer holds "
                             f"{p.w_gate.shape[0]}")
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
