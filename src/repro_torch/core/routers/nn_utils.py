"""Shared bits for the learned routers of the port (mirrors
`repro.core.routers.nn_utils`): tiny-net initializers, multi-head
attention, and a minibatch-AdamW trainer over the port's
`repro_torch.training.optimizer`.

Parameters are the reference's trees: dicts and lists of tensors whose
leaves keep the reference's names and shapes, a weight ``w`` in the
``(din, dout)`` layout (``x @ w + b``), so a leaf's path (``mlp_s/0/w``)
is its key in a router artifact of either package.  Initial weights are
drawn on the CPU from a `torch.Generator` and then moved, so a fit on the
card and a fit on the CPU start from the same numbers.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.training import optimizer as opt_mod


def linear_init(gen: torch.Generator, din, dout, scale=None):
    std = scale if scale is not None else 1.0 / np.sqrt(din)
    w = torch.randn((din, dout), generator=gen) * std
    return {"w": w, "b": torch.zeros((dout,))}


def linear(p, x):
    return x @ p["w"] + p["b"]


def mlp_params(gen: torch.Generator, dims):
    return [linear_init(gen, a, b) for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(ps, x, act=torch.relu):
    for i, p in enumerate(ps):
        x = linear(p, x)
        if i < len(ps) - 1:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# multi-head attention over generic token axes
# ---------------------------------------------------------------------------

def mha_init(gen: torch.Generator, d_model, n_heads=4, d_head=32):
    h = n_heads * d_head
    return {
        "wq": linear_init(gen, d_model, h),
        "wk": linear_init(gen, d_model, h),
        "wv": linear_init(gen, d_model, h),
        "wo": linear_init(gen, h, d_model),
    }


def mha(p, q_in, kv_in, nh: int = 4):
    """q_in: (..., Tq, D); kv_in: (..., Tk, D)."""
    q = linear(p["wq"], q_in)
    k = linear(p["wk"], kv_in)
    v = linear(p["wv"], kv_in)
    dh = q.shape[-1] // nh

    def split(x):
        return x.reshape(x.shape[:-1] + (nh, dh))
    qh, kh, vh = split(q), split(k), split(v)
    scores = torch.einsum("...qhd,...khd->...hqk", qh, kh) / np.sqrt(dh)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", probs, vh)
    out = out.reshape(out.shape[:-2] + (nh * dh,))
    return linear(p["wo"], out)


# ---------------------------------------------------------------------------
# inputs and losses of the learned routers
# ---------------------------------------------------------------------------

def inputs(X, device):
    """Host embeddings (Q, D) as f32 rows on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)


def mse_loss(predict):
    """Sum of the score and cost mean-squared errors of ``predict(p, b)``
    against the batch's ``s`` / ``c`` targets."""
    def loss_fn(p, b):
        s, c = predict(p, b)
        return torch.mean((s - b["s"]) ** 2) + torch.mean((c - b["c"]) ** 2)
    return loss_fn


def ce_loss(logits, y):
    """Mean negative log-likelihood of the labels ``y`` under ``logits``."""
    return -torch.log_softmax(logits, dim=1).gather(1, y[:, None]).mean()


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def flatten_tree(tree, prefix: str = "") -> Dict[str, object]:
    """{path: leaf} with the reference artifact's key scheme: dict keys and
    list indices joined by ``/``."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat: Dict[str, object]):
    """Inverse of `flatten_tree`: path components that are all digits
    rebuild lists, everything else dicts."""
    tree, children = {}, {}
    for key, val in flat.items():
        head, _, rest = key.partition("/")
        if rest:
            children.setdefault(head, {})[rest] = val
        else:
            tree[head] = val
    for head, sub in children.items():
        tree[head] = unflatten_tree(sub)
    if tree and all(k.isdigit() for k in tree):
        return [tree[k] for k in sorted(tree, key=int)]
    return tree


def to_device(tree, device):
    """Every leaf as a contiguous f32 tensor on ``device``."""
    def leaf(v):
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, np.float32))
        return v.to(device=device, dtype=torch.float32).contiguous()
    return unflatten_tree({k: leaf(v) for k, v in flatten_tree(tree).items()})


# ---------------------------------------------------------------------------
# generic trainer
# ---------------------------------------------------------------------------

class _GraphedStep:
    """The training step over full batches, replayed from a CUDA graph: the
    first ``WARMUP`` calls run eagerly on a side stream (what a capture
    needs before it), the next one captures the step reading its batch
    through a static index buffer, and every call from there copies the
    batch's row ids into that buffer and replays the whole forward,
    backward and optimizer step in one launch.  A step is the same kernels
    either way; the graph takes the host out of the loop."""
    WARMUP = 3
    #: graphs captured in this process (`analysis.sanitizers.port_caches`)
    captures = 0

    def __init__(self, step, data, batch_size, device):
        self.step, self.data = step, data
        self.idx = torch.empty((batch_size,), dtype=torch.int64,
                               device=device)
        self.calls, self.graph, self.out = 0, None, None

    def __call__(self, rows):
        if self.graph is None and self.calls < self.WARMUP:
            self.calls += 1
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = self.step({k: v[rows] for k, v in self.data.items()})
            torch.cuda.current_stream().wait_stream(side)
            return out
        if self.graph is None:
            _GraphedStep.captures += 1
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self.step({k: v[self.idx]
                                      for k, v in self.data.items()})
        self.idx.copy_(rows)
        self.graph.replay()
        return self.out


def train(params, loss_fn: Callable, data: Dict[str, object], *,
          epochs=100, batch_size=256, lr=1e-3, seed=0, weight_decay=0.01,
          device="cpu"):
    """loss_fn(params, batch_dict) -> scalar tensor.  Full shuffle each
    epoch: the reference's numpy permutations, last partial batch
    included.  ``params`` (a tree) is moved to ``device`` with ``data``
    (numpy arrays or tensors, one row per example), once; every epoch's
    permutation is uploaded in one copy before the first step, batches are
    gathered on the device, and no step waits for the host.  On a CUDA
    device the full batches replay one captured CUDA graph
    (`_GraphedStep`); the last partial batch of an epoch runs eagerly.
    Returns (params, (first loss, last loss)) with the losses as python
    floats, read once at the end (None, None for no step)."""
    n = len(next(iter(data.values())))
    opt_cfg = opt_mod.OptConfig(lr=lr, warmup_steps=5,
                                total_steps=max(1, epochs * max(n // batch_size, 1)),
                                weight_decay=weight_decay, clip_norm=1.0)
    flat = {k: v.detach().clone().requires_grad_(True)
            for k, v in flatten_tree(to_device(params, device)).items()}
    state = opt_mod.init(flat)
    data_d = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    rng = np.random.default_rng(seed)
    perms = torch.from_numpy(np.stack(
        [rng.permutation(n) for _ in range(epochs)]
        or [np.zeros(0, np.int64)])).to(device)

    def step(batch):
        loss = loss_fn(unflatten_tree(flat), batch)
        grads = torch.autograd.grad(loss, list(flat.values()))
        opt_mod.update(opt_cfg, dict(zip(flat, grads)), state, flat)
        return loss.detach()

    graphed = None
    if torch.device(device).type == "cuda" and n >= batch_size:
        graphed = _GraphedStep(step, data_d, batch_size, device)
    first = last = None
    for ep in range(epochs):
        for i in range(0, n, batch_size):
            rows = perms[ep, i: i + batch_size]
            if graphed is not None and len(rows) == batch_size:
                last = graphed(rows)
            else:
                last = step({k: v[rows] for k, v in data_d.items()})
            if first is None:
                first = last.clone()
    out = unflatten_tree({k: v.detach() for k, v in flat.items()})
    losses = (None, None) if last is None else (float(first), float(last))
    return out, losses
