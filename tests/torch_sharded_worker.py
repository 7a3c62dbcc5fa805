"""One gloo world of the port's sharded steps on the CPU, for
`test_torch_sharded_step.py`.

    python tests/torch_sharded_worker.py WORLD OUT_DIR

spawns WORLD ranks (a ``FileStore`` in OUT_DIR, ``GLOO_SOCKET_IFNAME=lo``)
on a (WORLD / 2, 2) ("data", "model") mesh.  Every rank runs every case
in the same order (the collectives must line up): the port's unsharded
step in this process on the whole batch (the oracle), and the same step
through `launch.steps` on `launch.shardings.shard_lm` of the same seeded
weights, fed the rank's block of the batch.  Rank r writes
OUT_DIR/rank<r>.npz: the sharded results gathered to whole values, the
oracle's beside them.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

#: (architecture, config overrides) of the train / prefill / decode cases
ARCHS = (("qwen3-4b", {}), ("mamba2-370m", {}),
         ("deepseek-v2-236b", {"moe_shard_map": True,
                               "capacity_factor": 8.0}),
         ("deepseek-v2-236b", {"capacity_factor": 8.0}))
B, S, STEPS, DECODE = 4, 32, 2, 4


def _cfg(arch, over):
    from repro_torch.configs import get_config, reduced
    return reduced(get_config(arch)).replace(dtype="float32", **over)


def blockwise_aux(mesh_shape):
    """The oracle's MoE layer for the expert-parallel contract: the local
    path's output, aux the mean of the Switch losses of the (data block,
    sequence block) pieces the mesh's ranks each route."""
    import torch
    from repro_torch.models import moe
    nd, m = mesh_shape
    orig = moe.moe_ffn

    def ffn(p, cfg, x, mesh=None):
        y, _ = orig(p, cfg.replace(moe_shard_map=False), x)
        Bx, Sx, D = x.shape
        bl, sl = Bx // nd, Sx // m
        aux = torch.stack([
            moe.route(p, cfg, x[d * bl:(d + 1) * bl,
                                r * sl:(r + 1) * sl].reshape(-1, D))[2]
            for d in range(nd) for r in range(m)]).mean()
        return y, aux
    ffn.dropped = ffn.routed = 0
    return orig, ffn


def _batch(cfg, rng):
    import torch
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(tok[:, 1:].astype(np.int32))}


def train_case(name, cfg, mesh, out):
    import torch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.training import optimizer as O
    rng = np.random.default_rng(1)
    batches = [_batch(cfg, rng) for _ in range(STEPS)]
    step = steps.train_fn(cfg)
    # the oracle: the unsharded step on the whole batch
    lm0 = M.init_params(cfg, seed=0, device="cpu")
    opt0 = O.init(dict(lm0.named_parameters()))
    # the contract's aux: one Switch loss a (data, model) block expert-
    # parallel, one a data rank's rows otherwise
    patched = bool(cfg.n_experts)
    if patched:
        nd, m = tuple(mesh.shape)
        orig, moe.moe_ffn = blockwise_aux((nd, m if cfg.moe_shard_map
                                           else 1))
    try:
        ref = [step(lm0, opt0, b) for b in batches]
    finally:
        if patched:
            moe.moe_ffn = orig
    # sharded: `steps.build`'s bundle, its zero batch replaced by the rank's
    # rows of each batch
    from repro_torch.configs.base import ShapeConfig
    bundle = steps.build(cfg, ShapeConfig("t", S, B, "train"), mesh,
                         device="cpu", seed=0)
    lm, opt, zeros = bundle.args
    got = []
    for b in batches:
        local = {k: SH.rank_block(mesh, SH.batch_spec(mesh, v.shape), v)
                 for k, v in b.items()}
        assert {k: v.shape for k, v in local.items()} == {
            k: v.shape for k, v in zeros.items()}
        got.append(bundle.fn(lm, opt, local))
    for key in ("loss", "aux_loss", "total_loss", "grad_norm", "tokens"):
        out[f"{name}_train_{key}"] = np.array([float(g[key]) for g in got])
        out[f"{name}_train_{key}_ref"] = np.array([float(r[key])
                                                   for r in ref])
    p0 = dict(lm0.named_parameters())
    for n, p in lm.named_parameters():
        out[f"{name}_param_{n}"] = p.full_tensor().detach().numpy()
        out[f"{name}_param_{n}_ref"] = p0[n].detach().numpy()
        exp = SH.placements(mesh, SH.leaf_spec(mesh, n, tuple(p.shape)))
        have = tuple(p.placements)
        if p.device_mesh.ndim == 1:          # replicated over the data axis
            have = exp[:1] + have
        out[f"{name}_placements_{n}"] = np.array(
            [str(a) == str(b) for a, b in zip(have, exp)])


def seqpar_case(mesh, out):
    """qwen3-4b's 2 train steps with the rule table's "seq" on "model"
    (the dry-run's ``--seq-parallel``: the residual stream sharded over
    the sequence, gathered at each block's input) against the unsharded
    step."""
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    cfg = _cfg("qwen3-4b", {})
    rng = np.random.default_rng(1)
    batches = [_batch(cfg, rng) for _ in range(STEPS)]
    step = steps.train_fn(cfg)
    lm0 = M.init_params(cfg, seed=0, device="cpu")
    opt0 = O.init(dict(lm0.named_parameters()))
    lm = SH.shard_lm(M.init_params(cfg, seed=0, device="cpu"), mesh,
                     rules=dict(DEFAULT_RULES, seq="model"))
    opt = O.init(dict(lm.named_parameters()))
    got, ref = [], []
    for b in batches:
        local = {k: SH.rank_block(mesh, SH.batch_spec(mesh, v.shape), v)
                 for k, v in b.items()}
        got.append(float(step(lm, opt, local)["loss"]))
        ref.append(float(step(lm0, opt0, b)["loss"]))
    out["seqpar_loss"], out["seqpar_loss_ref"] = np.array(got), np.array(ref)
    p0 = dict(lm0.named_parameters())
    names = sorted(p0)
    out["seqpar_params"] = np.concatenate([
        lm.get_parameter(n).full_tensor().detach().numpy().ravel()
        for n in names])
    out["seqpar_params_ref"] = np.concatenate([
        p0[n].detach().numpy().ravel() for n in names])


def prefill_decode_case(name, cfg, mesh, out, cache_len=S, steps_n=None):
    import torch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    rng = np.random.default_rng(2)
    batch = _batch(cfg, rng)
    lm0 = M.init_params(cfg, seed=0, device="cpu")
    lm = SH.shard_lm(M.init_params(cfg, seed=0, device="cpu"), mesh)
    bspec = SH.batch_spec(mesh, batch["tokens"].shape)
    with torch.no_grad():
        ref = M.forward(lm0, cfg, {"tokens": batch["tokens"]})[0]
        got = steps.prefill_fn(cfg)(lm, {"tokens": SH.rank_block(
            mesh, bspec, batch["tokens"])})
    out[f"{name}_prefill"] = got.full_tensor().numpy()
    out[f"{name}_prefill_ref"] = SH.rank_block(mesh, bspec, ref).numpy()
    # decode: DECODE tokens from zero caches, every rank its cache shard
    caches0 = M.init_caches(cfg, B, cache_len, device="cpu")
    caches = [{k: SH.rank_block(mesh, SH.cache_spec(mesh, k, t.shape, B),
                                   t.clone()) for k, t in c.items()}
              for c in caches0]
    dec = steps.decode_fn(cfg)
    n_steps = steps_n or DECODE
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n_steps, B, 1))
                            .astype(np.int32))
    tspec = SH._fit_spec(mesh, [SH.batch_axes(mesh), None], (B, 1))
    gl, rl = [], []
    for t in range(n_steps):
        pos = torch.tensor(t, dtype=torch.int32)
        r, _ = M.decode_step(lm0, cfg, caches0, toks[t],
                             torch.full((B,), t, dtype=torch.int32))
        g, _ = dec(lm, caches, SH.rank_block(mesh, tspec, toks[t]), pos)
        gl.append(g.full_tensor().numpy())
        rl.append(SH.rank_block(mesh, tspec, r).numpy())
    out[f"{name}_decode"] = np.stack(gl)
    out[f"{name}_decode_ref"] = np.stack(rl)


def ep_grad_case(mesh, out):
    """The expert-parallel layer (`moe.moe_shard_map`, every rank the same
    input, as the serving form runs it) against `moe.moe_local` on the
    whole batch: output, aux by the contract (the mean of the ranks'
    Switch losses) and the gradients of one loss through both, to the
    input, the router and the experts.  A rank's gradients are its share
    (its own tokens, the tokens its experts received), summed here over
    the ranks."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import convert, moe
    cfg = _cfg("deepseek-v2-236b", {"moe_shard_map": True,
                                    "capacity_factor": 8.0})
    rng = np.random.default_rng(3)
    full = moe.MoE(cfg, "cpu")
    full.init_(torch.Generator().manual_seed(5))
    names = list(mesh.mesh_dim_names)
    mr = mesh.get_coordinate()[names.index("model")]
    m = mesh.shape[names.index("model")]
    block = convert.moe_shard(full, cfg, mr, m, device="cpu")
    x = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(
        np.float32))
    gy = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(
        np.float32))
    nd = dist.get_world_size() // m
    D = cfg.d_model

    def oracle(p, xx):
        tokens = xx.reshape(-1, D)
        C = moe.capacity(tokens.shape[0], cfg.experts_top_k, cfg.n_experts,
                         cfg.capacity_factor)
        y, _ = moe.moe_local(p, cfg, tokens, C)
        bl, sl = B // nd, S // m
        aux = torch.stack([
            moe.route(p, cfg, xx[d * bl:(d + 1) * bl,
                                 r * sl:(r + 1) * sl].reshape(-1, D))[2]
            for d in range(nd) for r in range(m)]).mean()
        return y.reshape(xx.shape), aux

    def run(layer, fn):
        xx = x.clone().requires_grad_(True)
        for p in layer.parameters():
            p.requires_grad_(True)
            p.grad = None
        y, aux = fn(layer, xx)
        ((y * gy).sum() + aux).backward()
        return y.detach(), aux.detach(), xx.grad, layer

    y0, a0, gx0, l0 = run(full, oracle)
    y1, a1, gx1, l1 = run(block, lambda p, xx: moe.moe_shard_map(
        p, cfg, xx, mesh))
    for t in (gx1, l1.router.grad):
        dist.all_reduce(t)
    for n in ("w_gate", "w_up", "w_down"):     # one block: over the data axis
        dist.all_reduce(getattr(l1, n).grad, group=mesh["data"].get_group())
    el = cfg.n_experts // m
    out["ep_y"], out["ep_y_ref"] = y1.numpy(), y0.numpy()
    out["ep_aux"], out["ep_aux_ref"] = a1.numpy(), a0.numpy()
    out["ep_gx"], out["ep_gx_ref"] = gx1.numpy(), gx0.numpy()
    out["ep_grouter"], out["ep_grouter_ref"] = (l1.router.grad.numpy(),
                                                l0.router.grad.numpy())
    for n in ("w_gate", "w_up", "w_down"):
        out[f"ep_g{n}"] = getattr(l1, n).grad.numpy()
        out[f"ep_g{n}_ref"] = getattr(l0, n).grad[mr * el:(mr + 1) * el] \
            .numpy()


def norm_case(lm, out, name):
    """The card's clip over a sharded model's gradients
    (`optimizer.sharded_sumsq`: the norm pass over each placement's local
    shards, here its plain version, one all-reduced scalar each) against
    `global_norm`'s per-tensor whole sums."""
    import torch
    from repro_torch.training import optimizer as O
    grads = {n: p.grad for n, p in lm.named_parameters()
             if p.grad is not None}
    out[f"{name}_sharded"] = np.array(float(torch.sqrt(
        O.sharded_sumsq(list(grads.values())).float())))
    out[f"{name}_ref"] = np.array(float(O.global_norm(grads)))
    out[f"{name}_placements"] = np.array(sorted({
        str(tuple(g.placements)) for g in grads.values()}))


def router_case(mesh, out):
    """A bf16 MoE model's f32 router, which FSDP2 cannot group with the
    bf16 leaves of its unit (`shard_lm` shards it over the whole mesh by
    hand): its placements are its rule's, and its gradient, expert-parallel
    or not, is the unsharded step's (bf16 tolerance)."""
    import torch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import moe
    rng = np.random.default_rng(4)
    batch = _batch(_cfg("deepseek-v2-236b", {}), rng)
    for ep in (False, True):
        cfg = _cfg("deepseek-v2-236b", {"moe_shard_map": ep,
                                        "capacity_factor": 8.0}).replace(
            dtype="bfloat16")
        lm0 = M.init_params(cfg, seed=0, device="cpu")
        lm = SH.shard_lm(M.init_params(cfg, seed=0, device="cpu"), mesh)
        for p in lm0.parameters():
            p.requires_grad_(True)
        if ep:
            orig, moe.moe_ffn = blockwise_aux(tuple(mesh.shape))
        try:
            M.loss_fn(lm0, cfg, batch)[0].backward()
        finally:
            if ep:
                moe.moe_ffn = orig
        local = {k: SH.rank_block(mesh, SH.batch_spec(mesh, v.shape), v)
                 for k, v in batch.items()}
        with lm.sharding.context():
            total, _ = M.loss_fn(lm, cfg, local)
            total.backward()
        lm.sharding.sync_grads(lm)
        norm_case(lm, out, f"norm{int(ep)}")
        name = "blocks.1.moe.router"
        p = lm.get_parameter(name)
        out[f"router{int(ep)}_grad"] = p.grad.full_tensor().numpy()
        out[f"router{int(ep)}_grad_ref"] = lm0.get_parameter(
            name).grad.numpy()
        exp = SH.placements(mesh, SH.leaf_spec(mesh, name, tuple(p.shape)))
        out[f"router{int(ep)}_placements"] = np.array(
            [str(a) == str(b) for a, b in zip(p.placements, exp)])


def rank_main(rank, world, out_dir):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(out_dir) / "store"), world),
        rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh(world // 2, 2, device_type="cpu")
        out = {}
        for arch, over in ARCHS:
            name = arch.split("-")[0] + ("_ep" if over.get("moe_shard_map")
                                         else "")
            cfg = _cfg(arch, over)
            train_case(name, cfg, mesh, out)
            prefill_decode_case(name, cfg, mesh, out)
        # a sliding-window model's ring cache of 8 rows, past its wrap
        prefill_decode_case("danube", _cfg("h2o-danube-1.8b", {}), mesh,
                            out, cache_len=8, steps_n=12)
        ep_grad_case(mesh, out)
        router_case(mesh, out)
        seqpar_case(mesh, out)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    world, out_dir = int(sys.argv[1]), sys.argv[2]
    mp.spawn(rank_main, args=(world, out_dir), nprocs=world)
