"""Multi-pod dry-run of the model side (the counterpart of
`repro.launch.dryrun`): trace every (architecture x input shape) on the
production meshes and record each rank's memory, FLOPs and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --mesh single --out results/dryrun_torch.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

It needs no card.  Each pair runs `launch.steps.build`'s step once as
rank 0 of a fake process group of the mesh's ranks (256 for "single",
(16, 16); 512 for "multi", (2, 16, 16)) under ``FakeTensorMode``: the
model laid out by `launch.shardings.shard_lm` (FSDP2 over the data axes,
DTensor over "model"), nothing allocated or sent.  The kernel wrappers
allocate what their CUDA paths allocate and report their FLOPs
(`kernels.fake`), so the peak is the card's, not the plain versions'.
`launch.cost_analysis.measure` records the peak memory (FSDP2's memory
tracker, the optimizer state and inputs counted), the FLOPs, the eager
bytes and the collectives, by kind and by group size.

Eager tracing visits every layer, so the full-depth trace is the record;
the reference's extrapolation points (`reduced_depth` at (1, 0), (2, 0),
or (1, 1), (2, 1), (1, 2) with a tail) are traced and fitted too
(`cost_analysis.extrapolate`), and both are kept.  Records merge into
``--out`` under ``arch|shape|mesh[|tag]`` (`persist.atomic_write_text`),
so a sweep resumes: a pair already ``OK`` or ``SKIP`` is skipped unless
``--force``; a failure is recorded as ``FAIL: ...`` with its traceback
and the sweep goes on.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import json
import time
import traceback
from pathlib import Path

from repro_torch import persist
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, get_shape
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import fake_mesh

MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


def reduced_depth(cfg, g, t):
    return cfg.replace(n_groups=g, n_tail_groups=t if cfg.tail_pattern else 0,
                       encoder_layers=min(cfg.encoder_layers, g)
                       if cfg.encoder_layers else 0)


def extrapolation_points(cfg):
    return [(1, 1), (2, 1), (1, 2)] if cfg.tail_pattern else [(1, 0), (2, 0)]


@contextlib.contextmanager
def real_device_meshes():
    """``DeviceMesh`` keeps its rank map in real tensors, and FSDP2 makes
    meshes (its data mesh joined to "model") while the model's fake
    parameters are laid out: inside, every method and property of
    ``DeviceMesh`` runs with the fake mode off.  Model tensors never pass
    through them."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import DeviceMesh

    def real(fn):
        @functools.wraps(fn)
        def call(*a, **k):
            with unset_fake_temporarily():
                return fn(*a, **k)
        return call
    saved = {}
    for name, attr in list(vars(DeviceMesh).items()):
        if isinstance(attr, property):
            saved[name] = attr
            setattr(DeviceMesh, name, property(real(attr.fget)))
        elif isinstance(attr, staticmethod):
            saved[name] = attr
            setattr(DeviceMesh, name, staticmethod(real(attr.__func__)))
        elif inspect.isfunction(attr) and (not name.startswith("__") or name
                                           in ("__init__", "__getitem__")):
            saved[name] = attr
            setattr(DeviceMesh, name, real(attr))
    try:
        yield
    finally:
        for name, attr in saved.items():
            setattr(DeviceMesh, name, attr)


def trace(cfg, shape, mesh, rules=None):
    """Rank 0's step of (cfg, shape) traced once: a
    `cost_analysis.StepRecord`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import moe
    counts = moe.moe_ffn.dropped, moe.moe_ffn.routed
    try:
        with real_device_meshes(), FakeTensorMode():
            bundle = steps_mod.build(cfg, shape, mesh, device="cpu",
                                     rules=rules)
            lm, *rest = bundle.args
            _, rec = CA.measure(bundle.fn, *bundle.args, module=lm,
                                external=tuple(_tensors(rest)))
    finally:        # the MoE counters hold no fake tensor after the trace
        moe.moe_ffn.dropped, moe.moe_ffn.routed = counts
    return rec


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _numbers(rec):
    coll = CA.collective_bytes(rec.collectives)
    out = {"flops": float(rec.flops), "bytes": float(rec.bytes),
           "coll": coll["total"],
           **{f"coll_{k}": v for k, v in coll.items() if k != "total"}}
    out.update({f"coll_group_{g}": v for g, v in
                CA.collective_bytes_by_group(rec.collectives).items()})
    return out


def run_pair(arch: str, shape_name: str, mesh, mesh_name: str,
             extrapolate: bool = True, moe_shard_map: bool = False,
             seq_parallel: bool = False, remat_policy: str = "full",
             no_cross_kv: bool = False, mla_naive: bool = False,
             tag: str = "", cfg=None, shape=None) -> dict:
    """One record (the reference's fields; ``trace_s`` where it has
    ``compile_s``).  ``cfg`` / ``shape`` override the registry's (tests)."""
    cfg = cfg or get_config(arch)
    if moe_shard_map:
        cfg = cfg.replace(moe_shard_map=True)
    if remat_policy != "full":
        cfg = cfg.replace(remat_policy=remat_policy)
    if no_cross_kv:
        cfg = cfg.replace(cross_kv_cache=False)
    if mla_naive:
        cfg = cfg.replace(mla_naive_decode=True)
    rules = None
    if seq_parallel:
        from repro_torch.distributed.sharding import DEFAULT_RULES
        rules = dict(DEFAULT_RULES, seq="model")
    shape = shape or get_shape(shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mode": shape.mode, "tag": tag,
           "variant": {"moe_shard_map": moe_shard_map,
                       "seq_parallel": seq_parallel,
                       "remat_policy": remat_policy}}
    reason = steps_mod.skip_reason(cfg, shape)
    if reason:
        rec["status"] = reason
        return rec
    try:
        t0 = time.time()
        full = trace(cfg, shape, mesh, rules)
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["memory"] = CA.memory_summary(full)
        rec["raw_cost"] = CA.cost_summary(full)
        rec["raw_collectives"] = CA.collective_bytes(full.collectives)
        rec["coll_by_group"] = CA.collective_bytes_by_group(full.collectives)
        rec["kernel_flops"] = dict(full.kernel_flops)
        rec["depth"] = {"n_groups": cfg.n_groups,
                        "n_tail_groups": cfg.n_tail_groups}
        if extrapolate:
            pts = {gt: _numbers(trace(reduced_depth(cfg, *gt), shape, mesh,
                                      rules))
                   for gt in extrapolation_points(cfg)}
            rec["extrapolated"] = CA.extrapolate(pts, cfg.n_groups,
                                                 cfg.n_tail_groups)
            rec["extrapolation_points"] = {f"{g},{t}": v
                                           for (g, t), v in pts.items()}
        rec["status"] = "OK"
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def record_key(rec) -> str:
    key = f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"
    return key + (f"|{rec['tag']}" if rec.get("tag") else "")


def merge_out(path: Path, rec: dict):
    data = json.loads(path.read_text()) if path.exists() else {}
    data[record_key(rec)] = rec
    path.parent.mkdir(parents=True, exist_ok=True)
    persist.atomic_write_text(path, json.dumps(data, indent=1, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--moe-shard-map", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"])
    ap.add_argument("--mla-naive-decode", action="store_true",
                    help="baseline: naive latent-cache expansion")
    ap.add_argument("--no-cross-kv-cache", action="store_true",
                    help="baseline: recompute cross K/V per decode step")
    ap.add_argument("--tag", default="",
                    help="suffix key for perf-variant records")
    args = ap.parse_args(argv)

    out = Path(args.out)
    existing = json.loads(out.read_text()) if out.exists() else {}
    mesh_names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        pairs = [(a, s) for a in ARCHS for s in INPUT_SHAPES]
    else:
        pairs = [(args.arch, args.shape)]
    for mesh_name in mesh_names:
        mesh = fake_mesh(MESHES[mesh_name])
        # extrapolation (roofline) only on the single-pod mesh
        extrap = mesh_name == "single" and not args.no_extrapolate
        for a, s in pairs:
            key = f"{a}|{s}|{mesh_name}" + (f"|{args.tag}" if args.tag
                                             else "")
            if not args.force and key in existing and str(
                    existing[key].get("status", "")).startswith(("OK",
                                                                 "SKIP")):
                print(f"[skip cached] {key}")
                continue
            print(f"=== {key} ===", flush=True)
            rec = run_pair(a, s, mesh, mesh_name, extrapolate=extrap,
                           moe_shard_map=args.moe_shard_map,
                           seq_parallel=args.seq_parallel,
                           remat_policy=args.remat_policy,
                           no_cross_kv=args.no_cross_kv_cache,
                           mla_naive=args.mla_naive_decode, tag=args.tag)
            print(f"  -> {rec['status']} (trace {rec.get('trace_s', '-')}s)",
                  flush=True)
            merge_out(out, rec)


if __name__ == "__main__":
    main()
