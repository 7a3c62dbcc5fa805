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
averaged over the mesh: the mean of the ranks' Switch losses, each over
its own block (not the Switch loss of the whole batch).  Differentiable:
the collectives carry their gradients (`distributed.comm`), to the input
tokens, the router and the rank's expert block.

On a sharded model (`launch.shardings.shard_lm`) the input is a DTensor
on the "model" sub-mesh (a data rank's own batch) and the experts a
``Shard(0)`` DTensor over it after FSDP's all-gather: the layer takes its
local expert block explicitly (`_moe_tp`) and runs the same path over the
"model" ranks alone, the sequence split over them; without expert
parallelism each rank runs its own experts over their slots of the whole
layer's dispatch (`_moe_expert_sharded`), a ``Partial`` sum.

A layer that holds a block of experts (``cfg.moe_local_experts`` n > 0,
first id ``cfg.moe_first_expert``: one rank of DeepSeek-V2's expert-
parallel layout, `moe_held`), and any layer with the DeepSeek router
(holding all E), routes every token over all E experts and
computes its own experts over every choice that reached them, dropless:
the choices sorted by expert (stable; the others last), one grouped
product a weight over the held experts' rows (`grouped_swiglu`,
``torch._grouped_mm`` with device offsets, so nothing waits for the
host), back to (token, choice) order and summed over k in a fixed order.
Its output is the held block's share; the shared experts are added once.
The DeepSeek router (``cfg.moe_router`` "group_limited", `route_grouped`)
takes the softmax over all experts in f32, the best ``moe_topk_groups``
of ``moe_n_groups`` groups by their best score, the top k inside them
(ties to the lower id), gates = scores x ``moe_routed_scaling``, and the
per-sequence balance loss.  With tracing on, the spans ``moe.route`` and
``moe.experts`` and the counters ``moe.held_rows`` (choices the held
experts computed) and ``moe.held_peak_rows`` (rows of the busiest held
expert), a call each outside the backward pass (a remat's recompute is
not counted), accumulated on the card.

``moe_ffn.dropped`` / ``moe_ffn.routed`` count the (token, choice) slots
dropped at capacity and routed, summed over calls (device tensors, reset
by assigning 0)."""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import tracing
from repro_torch.distributed import comm, tp
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
    # a fixed-size count (not ``bincount``, whose size is the data's)
    counts = flat_e.new_zeros(E).scatter_add_(0, flat_e,
                                              torch.ones_like(flat_e))
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


def route_grouped(p: MoE, cfg, tokens, batch: int):
    """DeepSeek-V2's group-limited greedy router.  tokens: (T, D), T =
    ``batch`` x S in sequence order -> (gates (T, k) f32, idx (T, k)
    int64, aux):

        s = softmax(tokens W_r) over all E experts (f32)
        group score = the best s of each of the G groups of E / G experts
        kept = the top ``moe_topk_groups`` groups; idx = the top k of s over
        the kept groups' experts (descending, ties to the lower id)
        gates = s[idx] x ``moe_routed_scaling`` (not renormalised)
        aux = mean over sequences of sum_e f_e P_e, f_e = (choices of e in
        the sequence) E / (S k), P_e = the sequence's mean of s_e

    (aux is the per-sequence balance loss before its weight, alpha_1)."""
    T = tokens.shape[0]
    E, k = cfg.n_experts, cfg.experts_top_k
    G, kg = cfg.moe_n_groups, cfg.moe_topk_groups
    scores = torch.softmax(tokens.float() @ p.router, dim=-1)
    best = scores.view(T, G, E // G).amax(-1)
    _, gidx = torch.sort(best, dim=-1, descending=True, stable=True)
    keep = torch.zeros_like(best, dtype=torch.bool).scatter_(
        1, gidx[:, :kg], True)
    masked = scores.masked_fill(~keep.repeat_interleave(E // G, dim=1), 0.0)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    gates = vals[:, :k] * cfg.moe_routed_scaling
    idx = idx[:, :k]
    S = T // batch
    f = torch.zeros((batch, E), dtype=torch.float32, device=tokens.device)
    f.scatter_add_(1, idx.reshape(batch, S * k),
                   torch.ones((batch, S * k), dtype=torch.float32,
                              device=tokens.device))
    f = f / (S * k / E)
    aux = (f * scores.view(batch, S, E).mean(1)).sum(1).mean()
    return gates, idx, aux


def grouped_swiglu(p, xs, offs):
    """SwiGLU of the held experts over rows grouped by expert: xs (N, D),
    expert j's rows [offs[j - 1], offs[j]) (offs (n,) int32 on xs's
    device).  Rows from offs[-1] on are left unspecified (the caller
    selects them away).  One ``torch._grouped_mm`` a weight."""
    g = torch._grouped_mm(xs, p.w_gate, offs=offs)
    u = torch._grouped_mm(xs, p.w_up, offs=offs)
    return torch._grouped_mm(F.silu(g) * u, p.w_down, offs=offs)


def moe_held(p: MoE, cfg, x):
    """The held block's share of the layer, dropless (module docstring).
    x: (B, S, D) -> (y (B, S, D), aux)."""
    B, S, D = x.shape
    tokens = x.reshape(-1, D)
    T = tokens.shape[0]
    k = cfg.experts_top_k
    n, lo = p.w_gate.shape[0], cfg.moe_first_expert
    with tracing.span("moe.route"):
        if cfg.moe_router == "group_limited":
            gates, idx, aux = route_grouped(p, cfg, tokens, B)
        else:
            gates, idx, aux = route(p, cfg, tokens)
        flat = idx.reshape(-1)
        held = (flat >= lo) & (flat < lo + n)
        key = torch.where(held, flat - lo, torch.full_like(flat, n))
        order = torch.argsort(key, stable=True)
        counts = key.new_zeros(n + 1).scatter_add_(0, key,
                                                   torch.ones_like(key))
        offs = torch.cumsum(counts[:n], 0).to(torch.int32)
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device))
        hs = held[order][:, None]
    if torch._C._current_graph_task_id() == -1:     # not a recompute
        tracing.count("moe.held_rows", counts[:n].sum())
        tracing.count("moe.held_peak_rows", counts[:n].amax())
    with tracing.span("moe.experts"):
        src = tokens[:, None, :].expand(T, k, D).reshape(T * k, D)
        xs = torch.where(hs, src[order], torch.zeros((), dtype=src.dtype,
                                                      device=src.device))
        out = torch.where(hs, grouped_swiglu(p, xs, offs),
                          torch.zeros((), dtype=xs.dtype, device=xs.device))
        w = (gates.reshape(-1, 1) * held[:, None]).to(out.dtype)
        y = (out[inv] * w).to(tokens.dtype).reshape(T, k, D).sum(1)
    moe_ffn.routed = moe_ffn.routed + T * k
    return y.reshape(B, S, D), aux


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


def _combine(cfg, tokens, out, slot, keep, gates, count=True):
    """Expert outputs (E C, D) back to (T, D): each (token, choice) row
    times its gate (0 when dropped), summed over the k choices; ``count``
    adds the drops to `moe_ffn`'s counters."""
    T, D = tokens.shape
    k = cfg.experts_top_k
    flat_out = torch.cat([out, out.new_zeros((1, D))], 0)
    w = (gates.reshape(-1, 1) * keep[:, None]).to(out.dtype)
    y = (flat_out[slot] * w).to(tokens.dtype).reshape(T, k, D).sum(1)
    if count:
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


def _moe_tp(p: MoE, cfg, x):
    """`moe_ffn`'s routed experts on a sharded model: x a DTensor on the
    "model" sub-mesh, replicated over it; the experts ``Shard(0)`` over it
    where the axis divides E.  Expert-parallel: each rank its own block of
    the sequence and of the experts (`moe_shard_map`).  Else (or where the
    ranks do not divide the sequence: a decode step's one token) each rank
    routes all the tokens, the same on every rank, and runs its own
    experts over their slots only (`_moe_expert_sharded`); with the
    experts whole on every rank, the whole layer.  The router's and the
    input's gradients are a ``Partial`` sum over the ranks wherever each
    rank's share differs."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    B, S, D = x.shape
    part = [Partial()]
    if not p.w_gate.placements[0].is_shard():        # experts whole
        router = tp.data_gathered(p.router)
        lp = SimpleNamespace(router=tp.local(p.router) if router is None
                             else router, **{n: tp.local(getattr(p, n))
                                               for n in _EXPERT_LEAVES})
        tokens = x.to_local().reshape(-1, D)
        C = capacity(tokens.shape[0], cfg.experts_top_k, cfg.n_experts,
                     cfg.capacity_factor)
        y, aux = moe_local(lp, cfg, tokens, C)
        return DTensor.from_local(y.reshape(B, S, D), mesh,
                                  [Replicate()]), aux
    router = tp.data_gathered(p.router, partial_over_model=True)
    if router is None:
        router = p.router.to_local(grad_placements=part)
    lp = SimpleNamespace(router=router, **{n: getattr(p, n).to_local()
                                           for n in _EXPERT_LEAVES})
    xl = x.to_local(grad_placements=part)
    # aux stays a plain tensor (the same on every rank): a plain tensor
    # that needs a gradient must never meet a DTensor, whose implicit
    # replication would hand it back a DTensor gradient
    if expert_parallel(cfg, mesh) and S % mesh.size() == 0:
        y, aux = moe_shard_map(lp, cfg, xl, mesh)
        return DTensor.from_local(y, mesh, [Replicate()]), aux
    y, aux = _moe_expert_sharded(lp, cfg, xl.reshape(-1, D), mesh)
    return DTensor.from_local(y.reshape(B, S, D), mesh, part), aux


_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _moe_expert_sharded(p, cfg, tokens, mesh):
    """Routed experts with the tokens (T, D) on every rank and rank r
    holding experts [r E_l, (r + 1) E_l): the routing and the capacity are
    the whole layer's (every rank the same), the dispatch buffer holds
    this rank's experts' slots only, and y (T, D) is this rank's experts'
    share, which the ranks' ``Partial`` sum completes.  aux is computed
    on every rank; its gradient is shared out over the ranks (1 / m each)
    so that the sum of their gradients counts it once."""
    T, D = tokens.shape
    E, k = cfg.n_experts, cfg.experts_top_k
    m = mesh.size()
    el = p.w_gate.shape[0]
    C = capacity(T, k, E, cfg.capacity_factor)
    gates, idx, aux = route(p, cfg, tokens)
    slot, keep = dispatch_indices(idx.reshape(-1), E, C)
    lo = mesh.get_local_rank() * el * C
    mine = (slot >= lo) & (slot < lo + el * C)
    ls = torch.where(mine, slot - lo, torch.full_like(slot, el * C))
    src = tokens[:, None, :].expand(T, k, D).reshape(T * k, D)
    buf = tokens.new_zeros((el * C + 1, D)).index_put((ls,), src)
    out = expert_mm(p, buf[:el * C].reshape(el, C, D)).reshape(el * C, D)
    y = _combine(cfg, tokens, out, ls, keep & mine, gates, count=False)
    moe_ffn.dropped = moe_ffn.dropped + (~keep).sum()
    moe_ffn.routed = moe_ffn.routed + T * k
    return y, aux.detach() + (aux - aux.detach()) / m


def moe_ffn(p: MoE, cfg, x, mesh=None):
    """x: (B, S, D) -> (y, aux_loss), shared experts added; expert-parallel
    over ``mesh`` where `expert_parallel` holds (over a sharded model's
    "model" sub-mesh for a DTensor ``x``)."""
    B, S, D = x.shape
    if cfg.moe_local_experts or cfg.moe_router != "topk":
        if tp.is_dt(x):
            raise NotImplementedError(
                "moe_ffn: a held expert block or the group-limited router "
                "on a sharded model is not ported")
        y, aux = moe_held(p, cfg, x)
    elif tp.is_dt(x):
        y, aux = _moe_tp(p, cfg, x)
    elif expert_parallel(cfg, mesh):
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
