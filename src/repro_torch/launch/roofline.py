"""Roofline analysis over the model-side dry-run's records (the
counterpart of `repro.launch.roofline`), over the H100's constants.

Per (arch x shape) on the single-pod mesh, per rank:

    compute term    = FLOPs / PEAK_FLOPS[the config's dtype]
    memory term     = eager bytes / HBM_BW
    collective term = sum over groups of collective bytes / link_bw(g)

The constants are NVIDIA's data-sheet peaks for an "NVIDIA H100 80GB
HBM3" at 700.00 W (`launch.mesh`): the terms are bounds reckoned from the
trace, not measurements.  The record's numbers are the full-depth trace's
(eager tracing visits every layer; its extrapolation from the reference's
depth points equals it).  The eager bytes count every op's inputs and
outputs once, with no fusion, so the memory term is an upper bound.

MODEL_FLOPS = 6 N D (train) or 2 N D (prefill, decode), N the parameters
without embed / lm_head (the active ones for MoE), D the tokens; the
ratio MODEL_FLOPS / traced FLOPs exposes remat and dispatch overhead.

  PYTHONPATH=src python -m repro_torch.launch.roofline \\
      --in results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch import persist
from repro_torch.configs import get_config, get_shape
from .mesh import CARD, HBM_BW, PEAK_FLOPS, POWER_LIMIT, link_bw


def param_counts(cfg):
    """(total_params, active_params), excluding embed / lm_head, from the
    port's `LM` on the meta device; the routed experts are the ``moe``
    leaves ``w_gate`` / ``w_up`` / ``w_down`` (the reference's names)."""
    from repro_torch.models.model import LM
    lm = LM(cfg, device="meta")
    total = routed = 0
    for name, p in lm.named_parameters():
        parts = name.split(".")
        if parts[-1] in ("embed", "lm_head"):
            continue
        n = p.numel()
        total += n
        if "moe" in parts and parts[-1] in ("w_gate", "w_up", "w_down"):
            routed += n
    active = total
    if cfg.n_experts:
        active = total - routed * (1 - cfg.experts_top_k / cfg.n_experts)
    return total, int(active)


def tokens_for(shape):
    if shape.mode == "decode":
        return shape.global_batch          # one token per sequence
    return shape.global_batch * shape.seq_len


def _coll_groups(record):
    return {int(g): v for g, v in (record.get("coll_by_group") or {}).items()}


def analyze(record, n_chips=256):
    cfg = get_config(record["arch"])
    shape = get_shape(record["shape"])
    raw = record.get("raw_cost", {})
    flops = raw.get("flops", 0.0)
    bytes_ = raw.get("bytes", 0.0)
    groups = _coll_groups(record)
    coll = sum(groups.values())
    peak = PEAK_FLOPS[cfg.dtype]

    t_compute = flops / peak
    t_memory = bytes_ / HBM_BW
    t_coll = sum(v / link_bw(g) for g, v in groups.items())
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)

    total, active = param_counts(cfg)
    D = tokens_for(shape)
    mult = 6 if shape.mode == "train" else 2
    model_flops = mult * active * D / n_chips          # per rank
    ratio = model_flops / flops if flops else 0.0

    suggestion = {
        "compute": "reduce recompute (remat policy) / raise arithmetic "
                   "intensity with larger fused matmul tiles",
        "memory": "fuse the elementwise ops (the eager bytes count each "
                  "op's traffic) and shard activations over 'model'",
        "collective": "re-schedule collectives (all-to-all MoE, overlap "
                      "FSDP's all-gather / reduce-scatter with compute, "
                      "keep a group inside one node's NVLink)",
    }[dominant]

    return {
        "arch": record["arch"], "shape": record["shape"],
        "mode": shape.mode,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_per_dev": model_flops,
        "hlo_flops_per_dev": flops,
        "useful_ratio": ratio,
        "params_total": total, "params_active": active,
        "bytes_per_dev": bytes_, "coll_bytes_per_dev": coll,
        "coll_bytes_by_group": {str(g): v for g, v in groups.items()},
        "peak_bytes_per_dev": record.get("memory", {}).get("peak_bytes",
                                                           0.0),
        "peak_flops": peak, "hbm_bw": HBM_BW,
        "constants": f"NVIDIA data-sheet peaks, {CARD}, {POWER_LIMIT}",
        "what_would_move_it": suggestion,
    }


def fmt_row(a):
    return (f"| {a['arch']} | {a['shape']} | {a['t_compute_s']:.2e} | "
            f"{a['t_memory_s']:.2e} | {a['t_collective_s']:.2e} | "
            f"**{a['dominant']}** | {a['useful_ratio']:.2f} | "
            f"{a['peak_bytes_per_dev'] / 1e9:.1f} |")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--in", dest="inp", default="results/dryrun_torch.json")
    ap.add_argument("--out", default="results/roofline_torch.json")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)

    data = json.loads(Path(args.inp).read_text())
    n_chips = {"single": 256, "multi": 512}.get(args.mesh, 256)
    rows = []
    for key, rec in sorted(data.items()):
        if rec.get("mesh") != args.mesh:
            continue
        if not str(rec.get("status", "")).startswith("OK"):
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "status": rec.get("status")})
            continue
        rows.append(analyze(rec, n_chips))

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    persist.atomic_write_text(Path(args.out),
                              json.dumps(rows, indent=1, default=float))

    print(f"terms per rank over NVIDIA data-sheet peaks ({CARD}, "
          f"{POWER_LIMIT}), not measurements")
    print("| arch | shape | compute(s) | memory(s) | collective(s) | "
          "dominant | useful ratio | peak/rank (GB) |")
    print("|---|---|---|---|---|---|---|---|")
    for a in rows:
        if "dominant" in a:
            print(fmt_row(a))
        else:
            print(f"| {a['arch']} | {a['shape']} | - | - | - | "
                  f"{a['status']} | - | - |")
    return rows


if __name__ == "__main__":
    main()
