"""Training cells of an MLA + MoE model (DeepSeek-V2) on one expert-parallel
rank: `drivers/train.py`'s cell, with the configuration's keys mapped into
the port's config (MLA's latents and head dims, YaRN, the leading dense
layers, the group-limited router, the block of experts this card holds)
and the reference's loss carrying the balance term.

What the window drives and what is judged are `drivers/train.py`'s: the
port's `make_train_step` (MLA through kernels 2 / 2b at q / k 192 and v
128, the held experts by grouped products, per-layer remat, AdamW with f32
master weights) on the configuration's widths, and the plain reference
(`configs/<name>.ref.py`) following the same checked steps in float32:
step 1's loss (the next-token NLL; both sides add the same balance term to
what they differentiate), the worst leaf's change and whether a window
loss was not finite.  Read beside them and not compared: ``route_flips``,
the expert choices of step 1's forward pass in which the program and the
reference differ (a token's choice the other side did not make; the
program routes from bf16 activations, the reference from f32 ones, so near
ties go either way), summed over the MoE layers, and its share of all
choices, ``route_flip_share``.
"""
from __future__ import annotations

import gc

import torch

from bench import common, plain

_train = common.driver("train")

CHECKS = _train.CHECKS

#: the configuration's keys -> the port's `ModelConfig` fields
PORT_FIELDS = {"hidden_size": "d_model", "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "intermediate_size": "d_ff", "vocab_size": "vocab_size",
               "rope_theta": "rope_theta", "q_lora_rank": "q_lora_rank",
               "kv_lora_rank": "kv_lora_rank",
               "qk_nope_head_dim": "qk_nope_dim",
               "qk_rope_head_dim": "qk_rope_dim",
               "v_head_dim": "v_head_dim",
               "moe_intermediate_size": "moe_d_ff",
               "num_experts_per_tok": "experts_top_k",
               "n_shared_experts": "n_shared_experts",
               "n_group": "moe_n_groups", "topk_group": "moe_topk_groups",
               "routed_scaling_factor": "moe_routed_scaling",
               "aux_loss_alpha": "aux_weight"}
#: what the port's layers compute, which the configuration must state
FIXED = {"topk_method": "group_limited_greedy", "scoring_func": "softmax",
         "norm_topk_prob": False, "seq_aux": True, "hidden_act": "silu",
         "attention_bias": False, "tie_word_embeddings": False,
         "moe_layer_freq": 1, "rms_norm_eps": _train.PORT_RMS_EPS}


def port_config(cfg: dict):
    """The port's config for the configuration: its registered entry with
    every size the configuration states written in; the leading dense
    layers are the pattern, the MoE layers its tail."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLA_DENSE, MLA_MOE
    for k, v in FIXED.items():
        if cfg[k] != v:
            raise ValueError(f"the port computes {k} {v!r}, the "
                             f"configuration states {cfg[k]!r}")
    kw = {f: cfg[k] for k, f in PORT_FIELDS.items()}
    dense = cfg["first_k_dense_replace"]
    L = cfg["num_hidden_layers"]
    kw.update(n_layers=L, pattern=(MLA_DENSE,), n_groups=dense,
              tail_pattern=(MLA_MOE,), n_tail_groups=L - dense,
              n_experts=cfg["published"]["n_routed_experts"],
              moe_router="group_limited",
              moe_local_experts=cfg["n_routed_experts"],
              moe_first_expert=cfg["deployment"]["first_expert"],
              rope_scaling=tuple(sorted(cfg["rope_scaling"].items())),
              head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
              dtype=cfg["torch_dtype"], remat=True)
    return get_config(cfg["port_config"]).replace(**kw)


class Cell(_train.Cell):
    def setup(self):
        from repro_torch.models import model as M
        from repro_torch.models import moe
        from repro_torch.training import optimizer as O
        from repro_torch.training.train_step import make_train_step

        plain.no_tf32()
        self.pcfg = port_config(self.cfg)
        with self.spans.span("setup.weights"):
            w0 = self._weights()
            self.lm = M.LM(self.pcfg, self.dev)
            _train.load_weights(self.lm, w0)
            params = dict(self.lm.named_parameters())
            self.opt_state = O.init(params)
        self.step = make_train_step(self.pcfg, O.OptConfig(**self.opt))
        with self.spans.span("setup.batches"):
            self.batches = self._batches()
        self.losses = []
        n = int(self.tp["checked_steps"])
        b1 = float(self.opt["b1"])
        self.routes = []
        for i in range(n):
            with self.spans.span("setup.checked_step"):
                with _recording(moe, self.routes if i == 0 else None):
                    m = self.step(self.lm, self.opt_state, self.batches[i])
            self.losses.append(float(m["loss"]))
            if i == 0:
                self.grad_norms = {
                    k: float(v.float().norm()) / (1 - b1)
                    for k, v in self.opt_state["m"].items()}
        master = self.opt_state["master"]
        with torch.no_grad():
            self.change_norms = {k: float((master[k] - w0[k].float()).norm())
                                 for k in master}
        del w0
        self.next_batch = n
        self._sync()

    def layer_context(self, trace) -> dict:
        c = self.cfg
        ctx = {"kind": "lm_train_moe", "spans": self.spans, "trace": trace,
               "window_s": self.window_s, "steps": self.steps,
               "counters": _counters()}
        ctx["shape"] = {
            "B": int(self.tp["batch"]), "S": int(self.tp["seq"]),
            "H": c["num_attention_heads"], "dk": c["qk_nope_head_dim"]
            + c["qk_rope_head_dim"], "dv": c["v_head_dim"],
            "d": c["hidden_size"], "q_lora": c["q_lora_rank"],
            "kv_lora": c["kv_lora_rank"], "nope": c["qk_nope_head_dim"],
            "rope": c["qk_rope_head_dim"],
            "dense_layers": c["first_k_dense_replace"],
            "moe_layers": c["num_hidden_layers"]
            - c["first_k_dense_replace"],
            "d_ff": c["intermediate_size"],
            "f": c["moe_intermediate_size"],
            "shared": c["n_shared_experts"],
            "experts": c["published"]["n_routed_experts"],
            "held": c["n_routed_experts"], "vocab": c["vocab_size"],
            "dtype": c["torch_dtype"],
            "elt": torch.finfo(self.dtype).bits // 8}
        return ctx

    # ------------------------------------------------------------------
    def reference_run(self, precision="f32", half_batch=False,
                      record=None) -> dict:
        """`drivers/train.py`'s reference run with the reference's loss
        (total, nll): the gradient of the total, the nll compared;
        ``record`` takes step 1's expert choices."""
        pr = plain.Precision(precision)
        w0 = self._weights()
        w = {k: v.float().clone().requires_grad_(True) for k, v in w0.items()}
        adam = self.ref.AdamW(w, self.opt)
        losses, grads = [], None
        for i in range(int(self.tp["checked_steps"])):
            b = self.batches[i]
            tok, lab = b["tokens"], b["labels"]
            if half_batch:
                tok, lab = tok[:max(1, len(tok) // 2)], lab[:max(1,
                                                                len(lab) // 2)]
            total, nll = self.ref.loss(w, self.cfg, tok, lab, pr,
                                       record=record if i == 0 else None)
            g = torch.autograd.grad(total, list(w.values()))
            norms = adam.step(w, dict(zip(w, g)))
            del g, total
            losses.append(float(nll.detach()))
            if i == 0:
                grads = norms
        with torch.no_grad():
            change = {k: float((w[k] - w0[k].float()).norm()) for k in w}
        del w, w0, adam
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return {"losses": losses, "grads": grads, "change": change}

    def check(self, lim: dict) -> dict:
        ref_routes = []
        self._ref = self.reference_run(record=ref_routes)
        out = self.readings(self.program_answers(), self._ref, lim)
        flips, total = route_flips(self.routes, ref_routes)
        out["route_flips"] = flips
        out["route_flip_share"] = flips / total if total else None
        return out


class _recording:
    """While open, each call of the port's group-limited router outside a
    backward pass appends its choices (T, k) to ``into`` (None: nothing)."""

    def __init__(self, moe, into):
        self.moe, self.into = moe, into

    def __enter__(self):
        if self.into is None:
            return self
        self.orig = orig = self.moe.route_grouped
        into = self.into

        def route_grouped(*a, **kw):
            out = orig(*a, **kw)
            if torch._C._current_graph_task_id() == -1:
                into.append(out[1].detach().cpu())
            return out
        self.moe.route_grouped = route_grouped
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            self.moe.route_grouped = self.orig


def route_flips(prog, ref):
    """(choices of the program's that the reference's same token did not
    make, all choices), over the layers both recorded; tokens only one
    side routed count as flips whole."""
    flips = total = 0
    for a, b in zip(prog, ref):
        a, b = a.long(), b.long()
        n = min(len(a), len(b))
        matched = (a[:n, :, None] == b[:n, None, :]).any(-1)
        flips += int((~matched).sum()) + abs(a.numel() - b.numel())
        total += max(a.numel(), b.numel())
    return flips, total


def _counters():
    """The port's counters of the traced window, or None."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.summary()["counters"]
