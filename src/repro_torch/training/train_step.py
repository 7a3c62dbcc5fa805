"""The training step of the port (mirrors `repro.training.train_step`):
loss, backward, AdamW update."""
from __future__ import annotations

from repro_torch.models import model as M
from . import optimizer as opt_mod


def make_train_step(cfg, opt_cfg: opt_mod.OptConfig):
    """Returns ``train_step(lm, opt_state, batch) -> metrics``: the
    reference's metrics dict (loss, aux_loss, tokens, grad_norm, lr,
    total_loss, as tensors on the model's device); ``lm`` and
    ``opt_state`` are updated in place."""
    def train_step(lm, opt_state, batch):
        params = {n: p for n, p in lm.named_parameters()}
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        total, metrics = M.loss_fn(lm, cfg, batch)
        total.backward()
        grads = {n: p.grad for n, p in params.items()}
        opt_metrics = opt_mod.update(opt_cfg, grads, opt_state, params)
        for p in params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(metrics, **opt_metrics, total_loss=total.detach())
    return train_step
