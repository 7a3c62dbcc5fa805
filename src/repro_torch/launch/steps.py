"""The step functions, their inputs and their layouts over a mesh for every
(architecture x input shape) of the dry-run matrix: the counterpart of
`repro.launch.steps`.

Train builds the AdamW step (`training.train_step.make_train_step`) over
`launch.shardings.shard_lm` and `training.optimizer.init`; prefill the
forward's logits; decode ``decode_step`` (ONE token against a seq_len
cache) on the reference's sequence-sharded caches, with ``enc_out`` for
an encoder-decoder whose cross K / V cache is off.

SPMD: each rank runs the bundle's ``fn`` on its own blocks.  A
`StepBundle`'s ``args`` are this rank's tensors (its rows of the batch,
its shard of the caches, the model laid out by `shard_lm` with the
optimizer state beside it), ``in_placements`` / ``out_placements`` how
the whole values lie over the mesh (`launch.shardings`).  Under
``FakeTensorMode`` (the dry-run) nothing is allocated; elsewhere the
model is `models.model.init_params`' seeded one and the inputs zeros,
which a caller may replace with its own blocks (`launch.shardings.
rank_block`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.models import model as M
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step
from . import shardings as SH


class StepBundle(NamedTuple):
    fn: Any                 # fn(*args) -> outputs
    args: tuple             # this rank's inputs
    in_placements: tuple    # how each input's whole value lies on the mesh
    out_placements: Any
    meta: Dict[str, Any]


def sds(shape, dtype):
    """A meta tensor: the reference's ``ShapeDtypeStruct`` stand-in."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg, shape, with_labels: bool) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    batch: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision":
        n_text = S - cfg.num_patches
        batch["tokens"] = sds((B, n_text), i32)
        batch["patches"] = sds((B, cfg.num_patches, cfg.frontend_dim), bf16)
        if with_labels:
            batch["labels"] = sds((B, n_text), i32)
    elif cfg.is_encoder_decoder:
        enc_len = S // 2
        dec_len = S - enc_len
        batch["frames"] = sds((B, enc_len, cfg.frontend_dim), bf16)
        batch["tokens"] = sds((B, dec_len), i32)
        if with_labels:
            batch["labels"] = sds((B, dec_len), i32)
    else:
        batch["tokens"] = sds((B, S), i32)
        if with_labels:
            batch["labels"] = sds((B, S), i32)
    return batch


def skip_reason(cfg, shape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "SKIP(full-attention)"
    return None


def enc_len_for(cfg, shape) -> int:
    """Encoder rows of a decode shape's cross attention (0 without)."""
    S = shape.seq_len
    return min(4096, max(S // 8, 16)) if cfg.is_encoder_decoder else 0


def input_specs(cfg, shape) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this (arch, shape),
    with the reference's dtypes (int32 tokens, bf16 patches / frames, a
    scalar int32 position); decode's ``caches`` is `init_caches`' list of
    per-layer dicts."""
    if shape.mode == "train":
        return _batch_specs(cfg, shape, with_labels=True)
    if shape.mode == "prefill":
        return _batch_specs(cfg, shape, with_labels=False)
    B, S = shape.global_batch, shape.seq_len
    enc_len = enc_len_for(cfg, shape)
    caches = M.init_caches(cfg, B, S, device="meta",
                           long_mode=shape.name == "long_500k",
                           enc_len=enc_len)
    specs = {"caches": caches, "token": sds((B, 1), torch.int32),
             "pos": sds((), torch.int32)}
    if cfg.is_encoder_decoder and not cfg.cross_kv_cache:
        specs["enc_out"] = sds((B, enc_len, cfg.d_model), torch.bfloat16)
    return specs


def _zeros(mesh, spec, like, device):
    return torch.zeros(SH.local_shape(mesh, spec, tuple(like.shape)),
                       dtype=like.dtype, device=device)


def _make_lm(cfg, mesh, device, seed, rules):
    from repro_torch.kernels import fake
    if fake.is_fake(torch.empty(())):
        lm = M.LM(cfg, device)                  # fake: nothing to fill
    else:
        lm = M.init_params(cfg, seed=seed, device=device)
    return SH.shard_lm(lm, mesh, rules=rules)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def train_fn(cfg, opt_cfg=None):
    """``step(lm, opt_state, batch) -> metrics``: the AdamW step, which
    runs a sharded model in its sharding context itself."""
    return make_train_step(cfg, opt_cfg or O.OptConfig())


def prefill_fn(cfg, long_mode=False):
    """``fwd(lm, batch) -> logits`` of a sharded model."""
    def fwd(lm, batch):
        with lm.sharding.context():
            return M.forward(lm, cfg, batch, long_mode=long_mode)[0]
    return fwd


def decode_fn(cfg):
    """``decode(lm, caches, token, pos[, enc_out]) -> (logits, caches)`` of
    a sharded model: one token at the scalar position ``pos`` (the
    reference's), or a (B,) vector of them."""
    def decode(lm, caches, token, pos, enc_out=None):
        with lm.sharding.context():
            B = token.shape[0]
            posv = pos.reshape(-1).expand(B) if pos.numel() == 1 else pos
            if enc_out is not None:
                enc_out = enc_out.to(M.dtype_of(cfg))
            return M.decode_step(lm, cfg, caches, token,
                                 posv.to(torch.int32), enc_out=enc_out)
    return decode


def build(cfg, shape, mesh, *, device=None, seed=0, rules=None
          ) -> StepBundle:
    """The bundle of (cfg, shape) on ``mesh`` for this rank (module
    docstring).  ``device``: the mesh's device type by default; ``rules``:
    the activations' rule table (`distributed.sharding.DEFAULT_RULES` by
    default; the dry-run's ``--seq-parallel`` shards "seq" too)."""
    reason = skip_reason(cfg, shape)
    if reason:
        raise ValueError(reason)
    device = device or mesh.device_type
    long_mode = shape.name == "long_500k"
    lm = _make_lm(cfg, mesh, device, seed, rules)
    named = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    p_pl = SH.param_placements(mesh, named)
    B = shape.global_batch

    if shape.mode in ("train", "prefill"):
        specs = input_specs(cfg, shape)
        bspec = {k: SH.batch_spec(mesh, tuple(v.shape))
                 for k, v in specs.items()}
        batch = {k: _zeros(mesh, bspec[k], v, device)
                 for k, v in specs.items()}
        b_pl = SH.batch_placements(mesh, {k: tuple(v.shape)
                                          for k, v in specs.items()})
        n_text = specs["tokens"].shape[1] + (
            cfg.num_patches if cfg.frontend == "vision" else 0)
        logits_pl = SH.placements(mesh, SH._fit_spec(
            mesh, [SH.batch_axes(mesh), None, SH._ax(mesh, SH.TP)],
            (B, n_text, cfg.vocab_size)))
        if shape.mode == "prefill":
            return StepBundle(prefill_fn(cfg, long_mode), (lm, batch),
                              (p_pl, b_pl), logits_pl, {"mode": "prefill"})
        opt = O.init(dict(lm.named_parameters()))
        o_pl = SH.opt_placements(mesh, named)
        metrics_pl = {k: SH.replicated(mesh) for k in
                      ("loss", "aux_loss", "tokens", "grad_norm", "lr",
                       "total_loss")}
        return StepBundle(train_fn(cfg), (lm, opt, batch), (p_pl, o_pl, b_pl),
                          (p_pl, o_pl, metrics_pl), {"mode": "train"})

    specs = input_specs(cfg, shape)
    c_spec = [{k: SH.cache_spec(mesh, k, tuple(t.shape), B)
               for k, t in c.items()} for c in specs["caches"]]
    caches = [{k: _zeros(mesh, cs[k], t, device) for k, t in c.items()}
              for c, cs in zip(specs["caches"], c_spec)]
    c_pl = SH.cache_placements(mesh, specs["caches"], B)
    b = SH.batch_axes(mesh) if B > 1 else None
    tok_spec = SH._fit_spec(mesh, [b, None], (B, 1))
    token = _zeros(mesh, tok_spec, specs["token"], device)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    args = [lm, caches, token, pos]
    in_pl = [p_pl, c_pl, SH.placements(mesh, tok_spec), SH.replicated(mesh)]
    if "enc_out" in specs:
        e_spec = SH._fit_spec(mesh, [b, None, None],
                              tuple(specs["enc_out"].shape))
        args.append(_zeros(mesh, e_spec, specs["enc_out"], device))
        in_pl.append(SH.placements(mesh, e_spec))
    logits_pl = SH.placements(mesh, SH._fit_spec(
        mesh, [b, SH._ax(mesh, SH.TP)], (B, cfg.vocab_size)))
    return StepBundle(decode_fn(cfg), tuple(args), tuple(in_pl),
                      (logits_pl, c_pl), {"mode": "decode"})
