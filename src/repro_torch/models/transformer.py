"""Layer stack (mirrors `repro.models.transformer`): the reference's scanned
``(n_groups, ...)`` parameter stacks become one module per layer, in order
group by group, pattern slot by pattern slot, then the tail groups:

- `Block` for an attention layer ``("attn", "dense" | "moe")`` or an MLA
  layer ``("mla", "moe" | "dense")`` (DeepSeek's leading dense layers: a
  pattern of ``("mla", "dense")`` before a tail of ``("mla", "moe")``);
- `SSMBlock` for a Mamba-2 layer ``("ssm", "none")``;
- `SharedSlot`, which holds nothing, for a slot of the hybrid's shared
  attention block ``("shared_attn", "none")``: the one `SharedBlock` lives
  on the `LM` and is applied at every such slot, so its gradient sums over
  the slots.

An encoder-decoder's decoder layers (``cross=True``) also hold a cross
attention, `Block.cross` and `Block.norm_cross`, applied after the self
attention to the encoder's output: through the forward kernel in
`stack_full`, and in `stack_decode` through the decode kernel over the
cached cross K / V (``ck`` / ``cv`` of `caches_init(enc_len=)`) or, with
no cache, through the forward kernel at Sq 1 from ``enc_out``.  The
encoder is the same stack run with ``causal=False``."""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_DENSE, ATTN_MOE, MLA_DENSE,
                                      MLA_MOE, SHARED_ATTN, SSM)
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import active_mesh, constrain

from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import (GQA, MLA, gqa_cross_decode, gqa_decode, gqa_full,
                        mla_decode, mla_full)
from .layers import MLP, RMSNorm, dtype_of, mlp, rmsnorm

PORTED_SPECS = (ATTN_DENSE, ATTN_MOE, MLA_MOE, MLA_DENSE, SSM, SHARED_ATTN)


class _Layer(nn.Module):
    """A layer of the stack: its full-sequence pass runs through the module
    call (`_apply_full`), so FSDP's hooks (`launch.shardings.shard_lm`)
    see it."""

    def forward(self, *args):
        return _apply_full(self, *args)


class Block(_Layer):
    """One pre-norm attention (GQA or MLA) layer with a SwiGLU or MoE FFN;
    with ``cross`` (an encoder-decoder's decoder layer) also a pre-norm
    cross attention between them."""

    def __init__(self, cfg, spec, device, cross=False):
        super().__init__()
        kind, ffn = spec
        dt = dtype_of(cfg)
        self.norm1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = MLA(cfg, device) if kind == "mla" else GQA(cfg, device)
        if cross:
            self.norm_cross = RMSNorm(cfg.d_model, dt, device)
            self.cross = GQA(cfg, device)
        self.norm2 = RMSNorm(cfg.d_model, dt, device)
        if ffn == "moe":
            self.moe = moe_mod.MoE(cfg, device,
                                   n_local=cfg.moe_local_experts or None)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)

    def init_(self, generator):
        self.attn.init_(generator)
        if hasattr(self, "cross"):
            self.cross.init_(generator)
        (self.moe if hasattr(self, "moe") else self.mlp).init_(generator)


class SSMBlock(_Layer):
    """One pre-norm Mamba-2 mixer with no FFN (spec ``("ssm", "none")``)."""

    def __init__(self, cfg, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, dtype_of(cfg), device)
        self.ssm = ssm_mod.SSM(cfg, device)

    def init_(self, generator):
        self.ssm.init_(generator)


class SharedBlock(nn.Module):
    """The hybrid's shared transformer block (attention + SwiGLU), held
    once (the reference's ``stack/shared``)."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg)
        self.norm1 = RMSNorm(cfg.d_model, dt, device)
        self.attn = GQA(cfg, device)
        self.norm2 = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)

    def init_(self, generator):
        self.attn.init_(generator)
        self.mlp.init_(generator)


class SharedSlot(_Layer):
    """A slot of the shared block: no weights of its own."""

    def init_(self, generator):
        pass


def layer_specs(cfg):
    """Layer specs in execution order (``pattern`` x ``n_groups``, then the
    tail).  A spec outside `PORTED_SPECS` is refused, and so is an
    encoder-decoder with a decoder layer other than ``("attn", ...)``
    (cross attention lives on GQA layers only)."""
    specs = [tuple(s) for s in list(cfg.pattern) * cfg.n_groups
             + list(cfg.tail_pattern) * cfg.n_tail_groups]
    bad = sorted({s for s in specs if s not in PORTED_SPECS})
    if bad:
        raise NotImplementedError(f"{cfg.name}: layer specs {bad} are not "
                                  f"ported; the port runs {PORTED_SPECS}")
    if cfg.is_encoder_decoder and any(k != "attn" for k, _ in specs):
        raise NotImplementedError(f"{cfg.name}: cross attention on layers "
                                  f"other than GQA attention is not ported")
    return specs


def has_shared(cfg) -> bool:
    return any(k == "shared_attn" for k, _ in cfg.pattern + cfg.tail_pattern)


def stack_init(cfg, device, cross=False) -> nn.ModuleList:
    def one(spec):
        if spec == SSM:
            return SSMBlock(cfg, device)
        if spec == SHARED_ATTN:
            return SharedSlot()
        return Block(cfg, spec, device, cross=cross)
    return nn.ModuleList(one(spec) for spec in layer_specs(cfg))


def _norm(p, x):
    """A block's normed input, whole over the sequence: with the rule
    table's "seq" on "model" (the dry-run's ``--seq-parallel``) the
    residual stream is sequence-sharded and each block gathers its input
    here, as Megatron's sequence parallelism does (a no-op otherwise)."""
    return tp.replicate(rmsnorm(p, x))


def _ffn(blk, cfg, x):
    """The FFN half of a `Block`: (x + ffn(norm2 x), aux)."""
    h = _norm(blk.norm2, x)
    if hasattr(blk, "moe"):
        y, aux = moe_mod.moe_ffn(blk.moe, cfg, h, mesh=active_mesh())
        return x + tp.grad_whole(y), aux
    return x + tp.grad_whole(mlp(blk.mlp, h)), None


def _apply_full(blk, cfg, x, positions, shared, long_mode, enc_out=None,
                causal=True):
    """One layer over a full sequence; returns (x, aux or None), x laid
    out by the rule table (``constrain``: a sharded model's row-parallel
    outputs summed over "model")."""
    if isinstance(blk, SSMBlock):
        x = x + tp.grad_whole(ssm_mod.ssm_full(blk.ssm, cfg,
                                               _norm(blk.norm1, x)))
        return constrain(x, ("batch", "seq", "embed")), None
    if isinstance(blk, SharedSlot):
        w = cfg.shared_attn_window if long_mode else 0
        x = constrain(x + tp.grad_whole(gqa_full(
            shared.attn, cfg, _norm(shared.norm1, x), positions,
            causal=True, window=w)), ("batch", "seq", "embed"))
        x = x + tp.grad_whole(mlp(shared.mlp, _norm(shared.norm2, x)))
        return constrain(x, ("batch", "seq", "embed")), None
    h = _norm(blk.norm1, x)
    if isinstance(blk.attn, MLA):
        y = mla_full(blk.attn, cfg, h, positions)
    else:
        y = gqa_full(blk.attn, cfg, h, positions, causal=causal,
                     window=cfg.sliding_window)
    x = constrain(x + tp.grad_whole(y), ("batch", "seq", "embed"))
    if enc_out is not None and hasattr(blk, "cross"):
        y = gqa_full(blk.cross, cfg, _norm(blk.norm_cross, x), positions,
                     window=0, kv_x=enc_out)
        x = constrain(x + tp.grad_whole(y), ("batch", "seq", "embed"))
    x, aux = _ffn(blk, cfg, x)
    return constrain(x, ("batch", "seq", "embed")), aux


def stack_full(blocks, cfg, x, positions, shared=None, long_mode=False,
               enc_out=None, causal=True):
    """Apply the whole stack to a full sequence (training, forward, the
    encoder).  Returns (x, aux): aux sums the MoE layers' balance losses
    (an f32 zero without MoE).  With ``cfg.remat`` and gradients on, each
    layer is recomputed in the backward pass (`torch.utils.checkpoint`),
    as the reference checkpoints each scanned group: all of it with
    ``cfg.remat_policy`` "full", all but the matrix products without batch
    dims with "dots" (`dots_policy`).  Each layer runs through its module
    call (FSDP's hooks).  ``long_mode`` gives
    the shared block its sliding window ``cfg.shared_attn_window``;
    ``enc_out`` (B, Se, D) feeds the decoder layers' cross attention;
    ``causal=False`` is the encoder's bidirectional self-attention."""
    remat = cfg.remat and torch.is_grad_enabled()
    kw = {}
    if remat and cfg.remat_policy == "dots":
        kw["context_fn"] = dots_context
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in blocks:
        if remat:
            x, a = checkpoint(blk, cfg, x, positions, shared, long_mode,
                              enc_out, causal, use_reentrant=False, **kw)
        else:
            x, a = blk(cfg, x, positions, shared, long_mode, enc_out, causal)
        if a is not None:
            aux = aux + a
    return x, aux


def dots_policy(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: the outputs of
    matrix products without batch dims (``mm`` / ``addmm``: a weight
    product) are saved, everything else (``bmm``, the attention and SSD
    kernels, the pointwise ops) is recomputed in the backward pass."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(dots_policy)


def caches_init(cfg, batch, cache_len, device, long_mode=False,
                enc_len=0) -> List[Dict[str, torch.Tensor]]:
    """One cache per layer: for attention {"k", "v"} of (batch, S, KV, hd),
    a ring of S = min(cache_len, window) slots with a sliding window (the
    shared block's window only in ``long_mode``), and with ``enc_len`` an
    attention layer's cross K / V {"ck", "cv"} of (batch, enc_len, KV, hd)
    (`model.fill_cross_cache` fills them); for MLA the latent rows
    {"c": (batch, cache_len, kv_lora_rank), "kr": (batch, cache_len,
    qk_rope_dim)}; for an SSM layer the conv's trailing inputs and the SSD
    state."""
    dt = dtype_of(cfg)
    caches = []
    for spec in layer_specs(cfg):
        kind = spec[0]
        if kind == "ssm":
            caches.append(ssm_mod.ssm_state_init(cfg, batch, device))
            continue
        if kind == "mla":
            caches.append({
                "c": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                 dtype=dt, device=device),
                "kr": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                                  dtype=dt, device=device)})
            continue
        w = (cfg.sliding_window if kind == "attn"
             else cfg.shared_attn_window if long_mode else 0)
        S = min(cache_len, w) if w else cache_len
        shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
        if enc_len and kind == "attn":
            shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
            cache["ck"] = torch.zeros(shape, dtype=dt, device=device)
            cache["cv"] = torch.zeros(shape, dtype=dt, device=device)
        caches.append(cache)
    return caches


def _attn_decode(attn, cfg, x, cache, pos, w):
    ring = w if (w and cache["k"].shape[1] <= w) else 0
    h, cache["k"], cache["v"] = gqa_decode(attn, cfg, x, cache["k"],
                                           cache["v"], pos, window=ring)
    return h


def stack_decode(blocks, cfg, caches, x, pos, feed=None, shared=None,
                 enc_out=None):
    """One decode token through the stack; ``caches`` updated in place.
    ``feed`` (B,) bool, when given, names the slots this step feeds: an SSM
    layer keeps the old state of every other slot, so a recurrent state
    only ever holds its own request's tokens.  Attention caches take every
    slot's row (a stray row is overwritten when its slot writes that
    position).  A layer with cross attention attends to its cached cross
    K / V where the cache holds them, else to ``enc_out`` (projected anew
    each step), else not at all, as the reference's decode."""
    for blk, cache in zip(blocks, caches):
        with tp.unsharded(blk):
            x = _decode_one(blk, cfg, cache, x, pos, feed, shared, enc_out)
    return x, caches


def _decode_one(blk, cfg, cache, x, pos, feed, shared, enc_out):
    """One layer of `stack_decode`; returns x (laid out by the rule table,
    as `_apply_full`'s)."""
    emb = ("batch", "seq", "embed")
    if isinstance(blk, SSMBlock):
        h, new = ssm_mod.ssm_decode(blk.ssm, cfg, rmsnorm(blk.norm1, x),
                                    cache)
        for key, t in new.items():
            if feed is not None:
                keep = feed.view(-1, *([1] * (t.ndim - 1)))
                t = torch.where(keep, t.to(cache[key].dtype), cache[key])
            cache[key].copy_(t)
        return constrain(x + h, emb)
    if isinstance(blk, SharedSlot):
        x = constrain(x + _attn_decode(shared.attn, cfg,
                                       rmsnorm(shared.norm1, x), cache, pos,
                                       cfg.shared_attn_window), emb)
        return constrain(x + mlp(shared.mlp, rmsnorm(shared.norm2, x)), emb)
    h = rmsnorm(blk.norm1, x)
    if isinstance(blk.attn, MLA):
        y, cache["c"], cache["kr"] = mla_decode(blk.attn, cfg, h, cache["c"],
                                                cache["kr"], pos)
        x = x + y
    else:
        x = x + _attn_decode(blk.attn, cfg, h, cache, pos,
                             cfg.sliding_window)
    x = constrain(x, emb)
    if hasattr(blk, "cross") and ("ck" in cache or enc_out is not None):
        xin = rmsnorm(blk.norm_cross, x)
        if "ck" in cache:
            x = x + gqa_cross_decode(blk.cross, cfg, xin, cache["ck"],
                                     cache["cv"])
        else:
            x = x + gqa_full(blk.cross, cfg, xin, None, window=0,
                             kv_x=enc_out)
        x = constrain(x, emb)
    return constrain(_ffn(blk, cfg, x)[0], emb)
