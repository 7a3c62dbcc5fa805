"""Top-level language model (mirrors `repro.models.model`): embedding,
front end, layer stack (dense, MoE, MLA + MoE, Mamba-2 and the hybrid's
shared attention block), final norm, LM head.

    lm = init_params(get_config("qwen3-4b"), seed=0, device="cuda")
    caches = init_caches(cfg, batch=4, cache_len=512, device="cuda")
    logits, caches = decode_step(lm, cfg, caches, token, pos)
    logits, aux = forward(lm, cfg, {"tokens": tokens})
    total, metrics = loss_fn(lm, cfg, {"tokens": tokens, "labels": labels})

The front ends take the reference's stubbed inputs.  Vision
(internvl2-76b): ``batch["patches"]`` (B, P, frontend_dim), the image
encoder's output, projected by ``frontend_proj`` and prepended to the
text; the loss ignores the patch slots.  Audio (seamless-m4t-medium, an
encoder-decoder): ``batch["frames"]`` (B, Se, frontend_dim) projected and
run through a bidirectional encoder (`encode`), whose output every
decoder layer cross-attends to.  Decoding takes the encoder output once
into per-layer cross K / V caches (`init_caches(enc_len=)` and
`fill_cross_cache`), or as ``enc_out`` to `decode_step`, which then
projects it anew each step:

    enc = encode(lm, cfg, frames)
    caches = fill_cross_cache(lm, cfg, init_caches(cfg, 1, 256,
                              enc_len=enc.shape[1]), enc)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ATTN_DENSE
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import constrain
from . import transformer as tfm
from .attention import cross_kv
from .layers import RMSNorm, dense_init_, dtype_of, param, rmsnorm


class LM(nn.Module):
    """Parameters of one model; built empty, filled by `init_params` or
    `convert.params_from_jax`."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        dt = dtype_of(cfg)
        self.embed = param((cfg.vocab_size, cfg.d_model), dt, device)
        self.final_norm = RMSNorm(cfg.d_model, dt, device)
        self.lm_head = param((cfg.d_model, cfg.vocab_size), dt, device)
        self.blocks = tfm.stack_init(cfg, device,
                                     cross=cfg.is_encoder_decoder)
        if tfm.has_shared(cfg):
            self.shared = tfm.SharedBlock(cfg, device)
        if cfg.frontend in ("vision", "audio"):
            self.frontend_proj = param((cfg.frontend_dim, cfg.d_model), dt,
                                       device)
        if cfg.is_encoder_decoder:
            self.encoder = tfm.stack_init(enc_cfg(cfg), device)
            self.enc_norm = RMSNorm(cfg.d_model, dt, device)

    def forward(self, cfg, batch, long_mode=False):
        """`forward`'s body, run through the module call so that FSDP's
        hooks (`launch.shardings.shard_lm`) see it."""
        x, positions, enc_out = embed_inputs(self, cfg, batch)
        x = constrain(x, ("batch", "seq", "embed"))
        x, aux = tfm.stack_full(self.blocks, cfg, x, positions,
                                shared=getattr(self, "shared", None),
                                long_mode=long_mode, enc_out=enc_out)
        x = tp.replicate(rmsnorm(self.final_norm, x))
        logits = (x @ self.lm_head).float()
        return constrain(logits, ("batch", "seq", "vocab")), aux


def enc_cfg(cfg):
    """The encoder's config: ``cfg.encoder_layers`` dense attention layers
    with no window (the reference's ``_enc_cfg``)."""
    return cfg.replace(pattern=(ATTN_DENSE,), n_groups=cfg.encoder_layers,
                       tail_pattern=(), n_tail_groups=0, sliding_window=0)


def init_params(cfg, seed: int = 0, device="cuda") -> LM:
    """Seeded init: truncated-normal fan-in like the reference's
    `init_params`, drawn from a `torch.Generator` on ``device`` (so the
    numbers differ from JAX's and between device types)."""
    lm = LM(cfg, device)
    g = torch.Generator(device=device).manual_seed(seed)
    dense_init_(lm.embed, g, scale=1.0)
    dense_init_(lm.lm_head, g)
    for blk in lm.blocks:
        blk.init_(g)
    if hasattr(lm, "shared"):
        lm.shared.init_(g)
    if hasattr(lm, "frontend_proj"):
        dense_init_(lm.frontend_proj, g)
    for blk in getattr(lm, "encoder", ()):
        blk.init_(g)
    return lm


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def encode(lm: LM, cfg, frames):
    """The audio encoder: frames (B, Se, frontend_dim) -> (B, Se, D),
    ``frontend_proj``, then the encoder's layers with bidirectional
    attention (remat'd per layer as the decoder's), then ``enc_norm``."""
    x = frames @ lm.frontend_proj
    x, _ = tfm.stack_full(lm.encoder, enc_cfg(cfg), x, _positions(x),
                          causal=False)
    return tp.replicate(rmsnorm(lm.enc_norm, x))


def embed_inputs(lm: LM, cfg, batch):
    """(x, positions, enc_out): the token embeddings, with the projected
    patches prepended for a vision model; positions over the whole
    sequence; the encoder's output for an encoder-decoder (else None).
    Patches and frames are cast to the model's dtype first."""
    x = tp.embed(lm.embed, batch["tokens"])
    enc_out = None
    if cfg.frontend == "vision" and "patches" in batch:
        pe = batch["patches"].to(x.dtype) @ lm.frontend_proj
        x = torch.cat([pe, x], dim=1)
    if cfg.is_encoder_decoder:
        enc_out = encode(lm, cfg, batch["frames"].to(x.dtype))
    return x, _positions(x), enc_out


def forward(lm: LM, cfg, batch, long_mode=False):
    """Full-sequence forward (training / prefill).  batch["tokens"]:
    (B, S) int, with ``"patches"`` (vision) or ``"frames"`` (audio, which
    needs them).  Returns (logits (B, P + S, vocab) f32, aux): P patch
    positions first for a vision batch; aux sums the MoE layers' balance
    losses (0 without MoE).  ``long_mode`` gives the hybrid's shared block
    its sliding window.  On a sharded model (`launch.shardings.shard_lm`)
    the logits are a DTensor, vocabulary-sharded over "model" where the
    vocabulary divides, as the reference constrains them."""
    return lm(cfg, batch, long_mode=long_mode)


def loss_fn(lm: LM, cfg, batch, aux_weight=None):
    """Mean next-token cross-entropy over labels >= 0 (negative labels are
    ignored; a vision batch's patch positions take label -1), plus
    ``aux_weight`` (default ``cfg.aux_weight``, 0.01 as the reference's)
    times the aux loss.  Returns (total, metrics) with the reference's
    metric names."""
    if aux_weight is None:
        aux_weight = cfg.aux_weight
    logits, aux = forward(lm, cfg, batch)
    labels = batch["labels"].long()
    if cfg.frontend == "vision" and "patches" in batch:
        pad = labels.new_full(batch["patches"].shape[:2], -1)
        labels = torch.cat([pad, labels], dim=1)
    valid = labels >= 0
    n = valid.sum().clamp_min(1)
    shard = tp.is_dt(logits) and logits.placements[0].is_shard()
    if shard and logits.placements[0].dim == logits.ndim - 1:
        loss = _nll_sum_sharded(logits, labels, valid) / n
    elif shard and logits.placements[0].dim == 1:
        loss = _nll_sum_seq_sharded(logits, labels, valid) / n
    else:       # plain, or a replicated DTensor
        logp = F.log_softmax(tp.local(tp.replicate(logits)), dim=-1)
        nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / n
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": n.float()}


def _nll_sum_sharded(logits, labels, valid):
    """The summed next-token NLL of a sharded model's vocabulary-sharded
    logits (a DTensor on the "model" sub-mesh): each rank's max, sum of
    exponentials and label logit over its own columns, reduced over the
    ranks (`distributed.comm`'s replicated-result gradients), so no rank
    holds more than its own (N, V / m) f32 block and one temporary of its
    shape.  The loss is a plain tensor, the same on every rank."""
    lg = logits.to_local()
    from repro_torch.distributed import comm
    mesh = logits.device_mesh
    group = mesh.get_group()
    v0 = mesh.get_local_rank() * lg.shape[-1]
    m = comm.all_reduce_max(lg.amax(-1), group)
    lse = m + comm.all_reduce_sum(torch.exp(lg - m[..., None]).sum(-1),
                                  group).log()
    lo = labels.long() - v0
    own = (lo >= 0) & (lo < lg.shape[-1])
    picked = lg.gather(-1, lo.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
    picked = comm.all_reduce_sum(torch.where(own, picked,
                                             torch.zeros_like(picked)), group)
    return torch.where(valid, lse - picked, torch.zeros_like(lse)).sum()


def _nll_sum_seq_sharded(logits, labels, valid):
    """The summed NLL of sequence-sharded logits (the rule table's "seq" on
    "model": each rank the whole vocabulary of its own positions): each
    rank sums its rows, the ranks' sums are added (a plain tensor, the
    same on every rank)."""
    from repro_torch.distributed import comm
    mesh = logits.device_mesh
    lg = logits.to_local()
    r, sl = mesh.get_local_rank(), lg.shape[1]
    lab = labels[:, r * sl:(r + 1) * sl]
    ok = valid[:, r * sl:(r + 1) * sl]
    nll = -F.log_softmax(lg, dim=-1).gather(
        -1, lab.clamp_min(0)[..., None])[..., 0]
    return comm.all_reduce_sum(
        torch.where(ok, nll, torch.zeros_like(nll)).sum(), mesh.get_group())


def prefill(lm: LM, cfg, batch):
    """Logits of the full-sequence forward, as the reference's `prefill`
    (serving fills caches token by token)."""
    return forward(lm, cfg, batch)[0]


def init_caches(cfg, batch, cache_len, device="cuda", long_mode=False,
                enc_len=0):
    """Decode caches; ``enc_len`` adds an encoder-decoder's cross K / V
    caches of that many encoder rows (none with ``cfg.cross_kv_cache``
    off: decode then takes ``enc_out`` each step)."""
    use_enc = enc_len if (cfg.is_encoder_decoder and cfg.cross_kv_cache) \
        else 0
    return tfm.caches_init(cfg, batch, cache_len, device,
                           long_mode=long_mode, enc_len=use_enc)


@torch.no_grad()
def fill_cross_cache(lm: LM, cfg, caches, enc_out):
    """Project the encoder output (B, Se, D) into every decoder layer's
    cross K / V cache, once a request (the per-step projection otherwise).
    Returns ``caches``, updated in place."""
    for blk, cache in zip(lm.blocks, caches):
        if hasattr(blk, "cross") and "ck" in cache:
            cache["ck"], cache["cv"] = cross_kv(blk.cross, cfg, enc_out)
    return caches


@torch.no_grad()
def decode_step(lm: LM, cfg, caches, token, pos, feed=None, enc_out=None):
    """token: (B, 1) int; pos: (B,) int positions of this token; ``feed``
    (B,) bool, when given, the slots whose recurrent (SSM) state this step
    advances; ``enc_out`` (B, Se, D), the encoder output that cross
    attention projects anew where the caches hold no cross K / V.
    Returns (logits (B, vocab) f32, caches updated in place).  On a
    sharded model the caches are this rank's shards (`launch.shardings.
    cache_placements`) and the logits a DTensor."""
    with tp.unsharded(lm):
        x = tp.embed(lm.embed, token)
        x, caches = tfm.stack_decode(lm.blocks, cfg, caches, x, pos,
                                     feed=feed,
                                     shared=getattr(lm, "shared", None),
                                     enc_out=enc_out)
        x = rmsnorm(lm.final_norm, x)
        logits = (x @ lm.lm_head).float()
    return logits[:, 0], caches
