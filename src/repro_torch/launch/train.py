"""Training entry point of the port (mirrors `repro.launch.train`): seeded
weights, the zipf token stream, AdamW with f32 master weights.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --steps 10 --batch 4 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --reduced --device cpu --steps 5

On the card (the default ``--device cuda``) every SSM layer's intra-chunk
pass and its gradient run as CUDA kernels; ``--device cpu`` runs their
plain versions.  The flash attention kernel has no backward yet, so on the
card the port trains attention-free models.  Prints each logged step's
loss, grad norm and wall time; returns the per-step history.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.lm_data import DataConfig, SyntheticLMStream
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config for CPU execution")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = torch.device(args.device)
    print(f"[train] {cfg.name}: {cfg.total_blocks()} blocks, "
          f"d_model={cfg.d_model}, device={dev}")

    lm = M.init_params(cfg, seed=args.seed, device=dev)
    opt_cfg = O.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    opt_state = O.init(dict(lm.named_parameters()))
    step_fn = make_train_step(cfg, opt_cfg)
    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch(step).items()}
        met = step_fn(lm, opt_state, batch)
        sync()
        wall = time.perf_counter() - t_step
        rec = {"step": step, "loss": float(met["loss"]),
               "grad_norm": float(met["grad_norm"]), "wall_s": wall}
        history.append(rec)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"  step {step:4d} loss={rec['loss']:.4f} "
                  f"gnorm={rec['grad_norm']:.3f} "
                  f"({(time.perf_counter() - t0) / (step + 1):.2f}s/step)")

    if args.ckpt:
        CKPT.save(args.ckpt, dict(lm.named_parameters()))
        print(f"[train] saved checkpoint -> {args.ckpt}")
    return history


if __name__ == "__main__":
    main()
