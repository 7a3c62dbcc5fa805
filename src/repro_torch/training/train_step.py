"""The training step of the port (mirrors `repro.training.train_step`):
loss, backward, AdamW update.  The same step trains a sharded model
(`launch.shardings.shard_lm`): its forward and backward run in the
model's sharding context, the gradients FSDP leaves replicated are
averaged over the data ranks, and the metrics come back replicated (the
loss averaged over the data ranks' batches, the tokens summed).  With
tracing on (`repro_torch.tracing`), the step, its forward, its backward
(the remat's recompute included) and its optimizer update are spans."""
from __future__ import annotations

import contextlib

from repro_torch import tracing
from repro_torch.models import model as M
from . import optimizer as opt_mod


def make_train_step(cfg, opt_cfg: opt_mod.OptConfig):
    """Returns ``train_step(lm, opt_state, batch) -> metrics``: the
    reference's metrics dict (loss, aux_loss, tokens, grad_norm, lr,
    total_loss, as tensors on the model's device); ``lm`` and
    ``opt_state`` are updated in place."""
    def train_step(lm, opt_state, batch):
        with tracing.span("train.step"):
            return _step(lm, opt_state, batch)

    def _step(lm, opt_state, batch):
        params = {n: p for n, p in lm.named_parameters()}
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        sh = getattr(lm, "sharding", None)
        with sh.context() if sh else contextlib.nullcontext():
            with tracing.span("train.forward"):
                total, metrics = M.loss_fn(lm, cfg, batch)
            with tracing.span("train.backward"):
                total.backward()
        if sh:
            sh.sync_grads(lm)
        grads = {n: p.grad for n, p in params.items()}
        with tracing.span("train.optimizer"):
            opt_metrics = opt_mod.update(opt_cfg, grads, opt_state, params)
        for p in params.values():
            p.grad = None
        if sh:
            metrics = {k: sh.metric(v, "sum" if k == "tokens" else "mean")
                       for k, v in metrics.items()}
            return dict(metrics, **opt_metrics, total_loss=sh.metric(total))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(metrics, **opt_metrics, total_loss=total.detach())
    return train_step
