"""Training cells: the port's `make_train_step` (forward through kernel 2,
backward through kernel 2b, per-layer remat, AdamW with f32 master
weights) on a model of the configuration's sizes.

Set-up builds the one object the window drives: the model (the port's
`LM` of the configuration's widths and depth, its weights made on the card
from the seed in one call and handed over by name), the optimizer state
and the step, and the stream's batches (`bench.traffic`, rows that all
differ).  It drives that object through its first ``checked_steps`` steps
with the window's own call and feed, which also warm every shape, and
keeps what the comparison reads: each step's loss, each leaf's norm of
the gradient as the optimizer got it (from its first moment after step 1:
m / (1 - b1)) and of the weights' change after the checked steps (the f32
master weights against the initial ones, before step 4 moves them).

The window runs steps of the same object until ``--seconds`` have passed;
``train_tokens_per_s`` is every token of the steps completed over the
window's time (a step ends in a device sync).

What is judged (`check`), once the port's state is freed: the plain
reference (`configs/<name>.ref.py`) rebuilds the weights from the seed and
follows the same checked steps on the same batches in float32.  Compared:
the first step's loss (relative gap), the worst leaf's gap of change
norms over the reference's norm of that leaf or of the median leaf,
whichever is larger (leaves whose reference gradient is under a
thousandth of the median leaf's are left out), and whether any loss of
the window was not finite.  Read beside them and not compared: the later
steps' loss gaps (the run's third step follows a loss spike, and rounding
grows through it, from seed to seed 1e-3 to 5e-2) and the worst leaf's
gap of gradient norms (the bf16 embedding's, 2-3.5% on every seed, which
neither the control nor a fault reads ten times over).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import common, plain
from bench import traffic as T
from bench.profiling import Spans

#: the numbers compared.  The gap of the later steps' losses and of the
#: gradient norms are read and reported, not compared: neither has a
#: reading of the control or of a fault that stands above it (PERF.md)
CHECKS = ("loss1_gap", "update_gap", "nonfinite_losses")

#: the configuration's keys -> the port's `ModelConfig` fields
PORT_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
               "intermediate_size": "d_ff", "vocab_size": "vocab_size",
               "sliding_window": "sliding_window", "rope_theta": "rope_theta"}
#: the port's RMSNorm epsilon (`models/layers.py`), fixed for every model
PORT_RMS_EPS = 1e-6


def port_config(cfg: dict):
    """The port's config for the configuration: its registered entry with
    every size the configuration states written in."""
    from repro_torch.configs import get_config
    c = get_config(cfg["port_config"])
    kw = {f: cfg[k] for k, f in PORT_FIELDS.items()}
    kw["n_groups"] = cfg["num_hidden_layers"]
    kw["dtype"] = cfg["torch_dtype"]
    kw["remat"] = True
    if cfg["rms_norm_eps"] != PORT_RMS_EPS:
        raise ValueError(f"the port's RMSNorm runs eps {PORT_RMS_EPS}, the "
                         f"configuration states {cfg['rms_norm_eps']}")
    return c.replace(**kw)


class Cell:
    def __init__(self, spec):
        self.cfg = spec.cfg
        self.tp = spec.traffic
        self.seed = spec.seed
        self.dev = torch.device(spec.device)
        self.ref = common.reference(spec.config_name)
        self.spans = Spans()
        self.dtype = getattr(torch, self.cfg["torch_dtype"])
        self.opt = {k: v for k, v in self.cfg["optimizer"].items()
                    if k != "name"}

    def _weights(self):
        """The initial weights from the seed: one flat buffer in the
        configuration's dtype, drawn on the card in one call."""
        g = torch.Generator(device=self.dev).manual_seed(
            common.sub_seed(self.seed, "weights"))
        return plain.make_weights(self.ref.lm_specs(self.cfg), g, self.dev,
                                  dtype=self.dtype)

    def _batches(self):
        """Device batches of the stream: the checked steps and enough for
        any window, every row drawn anew."""
        stream = T.lm_stream(self.tp, self.cfg["vocab_size"], self.seed)
        n = int(self.tp["checked_steps"]) + int(self.tp.get("max_steps",
                                                             256))
        out = []
        for i in range(n):
            b = stream.batch(i)
            out.append({k: torch.from_numpy(v).to(self.dev, torch.int64)
                        for k, v in b.items()})
        return out

    # ------------------------------------------------------------------
    def setup(self):
        from repro_torch.models import model as M
        from repro_torch.training import optimizer as O
        from repro_torch.training.train_step import make_train_step

        plain.no_tf32()
        self.pcfg = port_config(self.cfg)
        with self.spans.span("setup.weights"):
            w0 = self._weights()
            self.lm = M.LM(self.pcfg, self.dev)
            load_weights(self.lm, w0)
            params = dict(self.lm.named_parameters())
            self.opt_state = O.init(params)
        self.step = make_train_step(self.pcfg, O.OptConfig(**self.opt))
        with self.spans.span("setup.batches"):
            self.batches = self._batches()
        self.losses = []
        n = int(self.tp["checked_steps"])
        b1 = float(self.opt["b1"])
        for i in range(n):
            with self.spans.span("setup.checked_step"):
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

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def warm_once(self):
        self._one_step()

    def _one_step(self):
        b = self.batches[self.next_batch % len(self.batches)]
        self.next_batch += 1
        with self.spans.span("step"):
            m = self.step(self.lm, self.opt_state, b)
            self._sync()
        return m

    def run_window(self, seconds: float) -> dict:
        self.spans.ms.clear()
        self.window_losses = []
        steps = 0
        t0 = time.perf_counter()
        t = 0.0
        while t < seconds:
            m = self._one_step()
            self.window_losses.append(m["loss"])
            steps += 1
            t = time.perf_counter() - t0
        self.window_s = t
        self.steps = steps
        self.attempted = steps
        self.failed = 0
        B, S = int(self.tp["batch"]), int(self.tp["seq"])
        return {"train_tokens_per_s": steps * B * S / t}

    def layer_context(self, trace) -> dict:
        c = self.cfg
        return {"kind": "lm_train", "spans": self.spans, "trace": trace,
                "window_s": self.window_s, "steps": self.steps,
                "shape": {"B": int(self.tp["batch"]),
                          "S": int(self.tp["seq"]),
                          "H": c["num_attention_heads"],
                          "KV": c["num_key_value_heads"],
                          "hd": c["head_dim"],
                          "layers": c["num_hidden_layers"],
                          "d": c["hidden_size"],
                          "d_ff": c["intermediate_size"],
                          "vocab": c["vocab_size"],
                          "window": c["sliding_window"],
                          "dtype": c["torch_dtype"],
                          "elt": torch.finfo(self.dtype).bits // 8}}

    def release(self):
        self.nonfinite = int(sum(not torch.isfinite(x).item()
                                 for x in self.window_losses))
        self.window_losses = None
        self.lm = self.opt_state = self.step = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def reference_run(self, precision="f32", half_batch=False) -> dict:
        """The reference's checked steps: losses, leaf gradient norms after
        step 1 (clipped, as the optimizer gets them) and leaf change norms
        after the last."""
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
            loss = self.ref.loss(w, self.cfg, tok, lab, pr)
            g = torch.autograd.grad(loss, list(w.values()))
            norms = adam.step(w, dict(zip(w, g)))
            del g
            losses.append(float(loss.detach()))
            if i == 0:
                grads = norms
        with torch.no_grad():
            change = {k: float((w[k] - w0[k].float()).norm()) for k in w}
        del w, w0, adam
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return {"losses": losses, "grads": grads, "change": change}

    def readings(self, ans: dict, ref: dict, lim: dict) -> dict:
        lr = np.asarray(ref["losses"])
        la = np.asarray(ans["losses"])
        gaps = np.abs(la - lr) / np.abs(lr)
        gnorm = ref["grads"]
        med = float(np.median(list(gnorm.values())))
        floor = float(lim.get("still_leaf", 1e-3)) * med

        ggaps = {k: abs(ans["grads"][k] - r) / max(r, med)
                 for k, r in gnorm.items()}
        moved = [k for k in gnorm if gnorm[k] >= floor]
        cmed = float(np.median([ref["change"][k] for k in moved]))
        cgaps = {k: abs(ans["change"][k] - ref["change"][k])
                 / max(ref["change"][k], cmed) for k in moved}
        return {"loss1_gap": float(gaps[0]),
                "update_gap": max(cgaps.values()),
                "later_loss_gap": float(gaps[1:].max()) if len(gaps) > 1
                else 0.0,
                "grad_gap": max(ggaps.values()),
                "nonfinite_losses": int(ans.get("nonfinite", 0)),
                "grad_gap_leaf": max(ggaps, key=ggaps.get),
                "update_gap_leaf": max(cgaps, key=cgaps.get),
                "leaves_still": int(sum(g < floor for g in gnorm.values())),
                "losses": [float(x) for x in la],
                "ref_losses": [float(x) for x in lr]}

    def program_answers(self) -> dict:
        return {"losses": self.losses, "grads": self.grad_norms,
                "change": self.change_norms,
                "nonfinite": getattr(self, "nonfinite", 0)}

    def check(self, lim: dict) -> dict:
        self._ref = self.reference_run()
        return self.readings(self.program_answers(), self._ref, lim)

    def control(self, lim: dict) -> dict:
        """The reference in the program's place with its products in fp8
        (e4m3, per-tensor scaled), the step below the configuration's
        bf16, judged as the program is."""
        return self.readings(self.reference_run("fp8"), self._ref, lim)

    def fault_half_batch(self, lim: dict) -> dict:
        """The reference in the program's place with half of each batch
        left out, the mean taken over the rest."""
        return self.readings(self.reference_run(half_batch=True), self._ref,
                             lim)


def load_weights(lm, weights: dict):
    """Copy the benchmark's weights into the port's parameters, by name;
    every parameter must be named, at its shape."""
    params = dict(lm.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights and the port's parameters differ: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            w = weights[name]
            if tuple(p.shape) != tuple(w.shape):
                raise ValueError(f"{name}: the port's {tuple(p.shape)}, the "
                                 f"benchmark's {tuple(w.shape)}")
            p.copy_(w)
