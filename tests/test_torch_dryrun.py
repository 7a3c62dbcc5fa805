"""The model-side dry-run of the port (`launch.shardings`, `launch.steps`,
`launch.dryrun`, `launch.roofline`, `launch.cost_analysis.extrapolate`)
against the reference's rules and counts, and one sweep of the dry-run on
reduced configs.

The rules, specs, parameter counts, cache layouts and step inputs are
compared at full size for all ten architectures, on both production
meshes: the reference side from ``jax.eval_shape`` and a stand-in mesh
with ``axis_names`` and ``shape`` (as `test_torch_distributed.py`'s
``test_spec_for_matches_reference``), or ``jax.sharding.AbstractMesh``
where the reference builds ``NamedSharding``s.  The dry-run itself runs
in one subprocess (rank 0 of fake process groups under
``FakeTensorMode``), on reduced configs at the reference's mini shapes.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("h2o-danube-1.8b", "qwen3-4b", "llama4-maverick-400b-a17b",
         "internvl2-76b", "mamba2-370m", "seamless-m4t-medium",
         "deepseek-v2-236b", "qwen1.5-32b", "starcoder2-15b", "zamba2-7b")
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}


class _Mesh:
    """The reference's view of a mesh: axis names and a size per name."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _key_str(k):
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


class _L:
    """A value held as one leaf of a reference tree."""

    def __init__(self, v):
        self.v = v


def _by_port_name(tree, cfg):
    """{port parameter / cache name: value} of a reference tree of `_L`
    leaves, through the port's layer order (`models.convert`): a stacked
    layer's leaf under ``blocks.<i>.`` / ``encoder.<i>.`` (parameters) or
    ``<i>.`` (caches, whose tree has only the stack's parts), the shared
    block's under ``shared.``."""
    from repro_torch.models import convert
    flat = {".".join(_key_str(k) for k in path): leaf.v for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, _L))[0]}
    caches = "groups" in tree
    out = {}
    for name, v in flat.items():
        head = name.split(".")
        if head[0] in ("stack", "encoder", "groups", "tail"):
            if head[:2] == ["stack", "shared"]:
                out[".".join(head[1:])] = v
            continue
        out[name] = v
    stacks = [("", "", cfg)] if caches else convert._stacks(cfg)
    for key, mods, c in stacks:
        for li, (part, i, _) in enumerate(convert._layer_sources(c)):
            prefix = f"{key}.{part}.{i}." if key else f"{part}.{i}."
            for name, v in flat.items():
                if name.startswith(prefix):
                    tail = name[len(prefix):]
                    out[f"{mods}.{li}.{tail}" if mods else f"{li}.{tail}"] = v
    return out


def _ref_param_specs(arch, mesh, **over):
    from repro.configs import get_config
    from repro.launch.shardings import _leaf_spec
    from repro.models import model as RM
    from repro_torch.configs import get_config as port_config
    cfg = get_config(arch).replace(**over)
    shapes = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    specs = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _L(tuple(_leaf_spec(mesh, p, leaf))), shapes)
    stacked = _by_port_name(specs, port_config(arch).replace(**over))
    return {n: (s[1:] if n.split(".")[0] in ("blocks", "encoder") else s)
            for n, s in stacked.items()}


def _port_param_specs(arch, mesh, **over):
    from repro_torch.configs import get_config
    from repro_torch.launch.shardings import leaf_spec
    from repro_torch.models.model import LM
    lm = LM(get_config(arch).replace(**over), device="meta")
    return {n: leaf_spec(mesh, n, tuple(p.shape))
            for n, p in lm.named_parameters()}


def test_rules_equal_reference():
    from repro.launch import shardings as REF
    from repro_torch.launch import shardings as SH
    assert SH._RULES == REF._RULES
    assert (SH.FSDP, SH.TP) == (REF.FSDP, REF.TP)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_specs_match_reference(arch):
    """Every parameter's spec, at full size on both production meshes,
    equals the reference's ``_leaf_spec`` of its leaf (the stacked
    leaves' leading None dropped: the port has one module per layer)."""
    for names, sizes in MESHES.values():
        mesh = _Mesh(names, sizes)
        ref = _ref_param_specs(arch, mesh)
        got = _port_param_specs(arch, mesh)
        assert set(got) == set(ref)
        for n in got:
            assert got[n] == ref[n], (n, got[n], ref[n])


def test_fit_spec_drops_an_axis_that_does_not_divide():
    """A vocabulary of 257 divides by no axis: the embedding and the head
    lose their vocabulary sharding, as the reference's ``_fit_spec``
    drops it."""
    for names, sizes in MESHES.values():
        mesh = _Mesh(names, sizes)
        ref = _ref_param_specs("qwen3-4b", mesh, vocab_size=257)
        got = _port_param_specs("qwen3-4b", mesh, vocab_size=257)
        assert got == ref
        assert got["embed"][0] is None and got["lm_head"][1] is None


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.launch.roofline import param_counts as ref_counts
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import param_counts
    assert param_counts(get_config(arch)) == ref_counts(ref_config(arch))


@pytest.mark.parametrize("arch", ("qwen3-4b", "deepseek-v2-236b",
                                  "zamba2-7b", "seamless-m4t-medium"))
def test_cache_placements_match_reference(arch):
    """`cache_spec` of every per-layer cache leaf (K / V, cross K / V, MLA
    latents, SSD and conv states) equals the reference's
    ``cache_shardings`` spec of that leaf, group axis dropped; batch 128
    (sharded) and 1 (not)."""
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as ref_config
    from repro.launch.shardings import cache_shardings
    from repro.models import model as RM
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as M
    for names, sizes in MESHES.values():
        amesh = AbstractMesh(sizes, names)
        for B in (128, 1):
            rc = ref_config(arch)
            shapes = jax.eval_shape(lambda: RM.init_caches(
                rc, B, 4096, enc_len=64 if rc.is_encoder_decoder else 0))
            specs = jax.tree.map(lambda s: _L(tuple(s.spec)),
                                 cache_shardings(amesh, shapes, B))
            ref = _by_port_name(specs, get_config(arch))
            caches = M.init_caches(get_config(arch), B, 4096,
                                   device="meta", enc_len=64)
            kinds = set()
            for li, c in enumerate(caches):
                for leaf, t in c.items():
                    got = SH.cache_spec(_Mesh(names, sizes), leaf,
                                        tuple(t.shape), B)
                    want = ref[f"{li}.{leaf}"][1:]
                    assert got == want, (li, leaf, got, want)
                    kinds.add(leaf)
            assert kinds


def test_extrapolate_matches_reference():
    """The fit on seeded numbers: the 2-point line, the 3-point plane and
    the singular system's fallback, every metric key."""
    from repro.launch.hlo_analysis import extrapolate as ref_extrap
    from repro_torch.launch.cost_analysis import extrapolate
    rng = np.random.default_rng(0)

    def pts(keys):
        return {k: {m: float(rng.uniform(1, 1e12)) for m in
                    ("flops", "bytes", "coll", "coll_all-gather")}
                for k in keys}
    cases = [(pts([(1, 0), (2, 0)]), 24, 0),
             (pts([(1, 1), (2, 1), (1, 2)]), 13, 3),
             (pts([(1, 1), (2, 1), (3, 1)]), 13, 3)]     # singular
    for costs, g, t in cases:
        got, ref = extrapolate(costs, g, t), ref_extrap(costs, g, t)
        assert set(got) == set(ref) == {"flops", "bytes", "coll",
                                        "coll_all-gather"}
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-12), k


def test_analyze_on_a_hand_made_record():
    """Each term is the record's bytes or FLOPs over the stated data-sheet
    constant; the collective term sums each group's bytes over its link."""
    from repro_torch.launch.mesh import (HBM_BW, NDR_BW, NVLINK_BW,
                                         PEAK_FLOPS)
    from repro_torch.launch.roofline import analyze, param_counts
    from repro_torch.configs import get_config
    rec = {"arch": "qwen3-4b", "shape": "train_4k",
           "raw_cost": {"flops": 3e14, "bytes": 5e12},
           "coll_by_group": {"16": 4e10, "8": 9e9, "2": 1e9},
           "memory": {"peak_bytes": 7e10}}
    a = analyze(rec, 256)
    assert a["t_compute_s"] == pytest.approx(3e14 / PEAK_FLOPS["bfloat16"])
    assert a["t_memory_s"] == pytest.approx(5e12 / HBM_BW)
    assert a["t_collective_s"] == pytest.approx(4e10 / NDR_BW
                                                + 1e10 / NVLINK_BW)
    assert a["dominant"] == "memory"
    total, active = param_counts(get_config("qwen3-4b"))
    assert a["useful_ratio"] == pytest.approx(
        6 * active * 256 * 4096 / 256 / 3e14)
    assert "data-sheet" in a["constants"]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """`steps.input_specs`' shapes and dtypes equal the reference's for
    every input shape (caches leaf by leaf, group axis dropped)."""
    from repro.configs import INPUT_SHAPES, get_config as ref_config
    from repro.launch import steps as RS
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import steps
    for name in INPUT_SHAPES:
        for over in ({}, {"cross_kv_cache": False}):
            rc = ref_config(arch).replace(**over)
            cfg = get_config(arch).replace(**over)
            ref = RS.input_specs(rc, INPUT_SHAPES[name])
            got = steps.input_specs(cfg, get_shape(name))
            assert set(got) == set(ref)
            for k in got:
                if k == "caches":
                    flat = _by_port_name(jax.tree.map(_L, ref[k]), cfg)
                    n = 0
                    for li, c in enumerate(got[k]):
                        for leaf, t in c.items():
                            r = flat[f"{li}.{leaf}"]
                            assert tuple(t.shape) == r.shape[1:], (li, leaf)
                            assert str(t.dtype)[6:] == str(r.dtype)
                            n += 1
                    assert n == len(flat)
                else:
                    assert tuple(got[k].shape) == ref[k].shape, k
                    assert str(got[k].dtype)[6:] == str(ref[k].dtype), k


# ---------------------------------------------------------------------------
# the dry-run, in one subprocess
# ---------------------------------------------------------------------------

#: reduced configs at 4 groups of one layer (zamba2: its two-layer
#: pattern and a tail of 2) at the reference's mini shapes, on a fake
#: (2, 2) mesh with the extrapolation points (and qwen3-4b sequence-
#: parallel) and on the (16, 16) one without ("pairs" MESH); the
#: kernels' fake path against the plain versions' peak ("peaks"); the
#: CLI's resume, a second run skipping and --force rerunning ("cli").
#: Four processes, started together.
DRY_PROG = r"""
import io, json, sys, contextlib
from pathlib import Path
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ATTN_DENSE, MLA_MOE, SSM, ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_mesh
part, out = sys.argv[1], Path(sys.argv[2])
MINI = {"mini_train": ShapeConfig("mini_train", 32, 4, "train"),
        "mini_decode": ShapeConfig("mini_decode", 32, 4, "decode"),
        "mini_prefill": ShapeConfig("mini_prefill", 1024, 1, "prefill")}
ONE = {"qwen3-4b": (ATTN_DENSE,), "deepseek-v2-236b": (MLA_MOE,),
       "seamless-m4t-medium": (ATTN_DENSE,)}

def cfg_of(arch):
    c = reduced(get_config(arch)).replace(n_groups=4)
    if arch in ONE:
        c = c.replace(pattern=ONE[arch])
    if arch == "zamba2-7b":
        c = c.replace(tail_pattern=(SSM,), n_tail_groups=2)
    return c

PAIRS = [("qwen3-4b", "mini_train", {}),
         ("deepseek-v2-236b", "mini_train", {"moe_shard_map": True}),
         ("zamba2-7b", "mini_train", {}),
         ("seamless-m4t-medium", "mini_decode", {"no_cross_kv": True})]
if part == "pairs":
    name, shape = sys.argv[3], tuple(int(a) for a in sys.argv[4].split("x"))
    mesh = fake_mesh(shape)
    for arch, s, kw in PAIRS:
        rec = D.run_pair(arch, s, mesh, name, cfg=cfg_of(arch),
                         shape=MINI[s], extrapolate=name == "mini22", **kw)
        D.merge_out(out, rec)
    if name == "mini22":
        D.merge_out(out, D.run_pair(
            "qwen3-4b", "mini_train", mesh, name, cfg=cfg_of("qwen3-4b"),
            shape=MINI["mini_train"], extrapolate=False, seq_parallel=True,
            tag="seqpar"))
elif part == "peaks":
    from repro_torch.kernels import fake
    mesh = fake_mesh((2, 2))
    c = cfg_of("qwen3-4b").replace(n_groups=1)
    peaks = {"kernel": D.trace(c, MINI["mini_prefill"], mesh).peak_bytes}
    real = fake.is_fake
    fake.is_fake = lambda t: False
    try:
        peaks["plain"] = D.trace(c, MINI["mini_prefill"], mesh).peak_bytes
    finally:
        fake.is_fake = real
    out.write_text(json.dumps(peaks))
else:
    # the registry's lookups pointed at the reduced configs
    D.ARCHS = {"qwen3-4b": None}
    D.INPUT_SHAPES = {"mini_train": None}
    D.get_config, D.get_shape = cfg_of, MINI.__getitem__
    D.MESHES = {"single": (2, 2)}
    logs = []
    for argv in ([], [], ["--force"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            D.main(["--all", "--no-extrapolate", "--out",
                    str(out.parent / "cli.json")] + argv)
        logs.append(buf.getvalue())
    out.write_text(json.dumps(logs))
"""


@pytest.fixture(scope="module", autouse=True)
def _dry_procs(tmp_path_factory):
    """The dry-run's processes, started before the module's first test so
    that they run beside the in-process comparisons."""
    tmp = tmp_path_factory.mktemp("dry")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jobs = {"mini22": ["pairs", tmp / "dry.json", "mini22", "2x2"],
            "single": ["pairs", tmp / "dry16.json", "single", "16x16"],
            "peaks": ["peaks", tmp / "peaks.json"],
            "cli": ["cli", tmp / "cli.log.json"]}
    procs = {k: subprocess.Popen([sys.executable, "-c", DRY_PROG]
                                 + [str(a) for a in argv], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, argv in jobs.items()}
    yield tmp, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def dry(_dry_procs):
    tmp, procs = _dry_procs
    logs = {k: p.communicate(timeout=300)[0] for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}:\n{logs[k][-6000:]}"
    return {"records": {**json.loads((tmp / "dry.json").read_text()),
                        **json.loads((tmp / "dry16.json").read_text())},
            "peaks": json.loads((tmp / "peaks.json").read_text()),
            "cli": json.loads((tmp / "cli.log.json").read_text()),
            "cli_out": json.loads((tmp / "cli.json").read_text())}


@pytest.mark.parametrize("mesh", ("mini22", "single"))
@pytest.mark.parametrize("pair", ("qwen3-4b|mini_train",
                                  "deepseek-v2-236b|mini_train",
                                  "zamba2-7b|mini_train",
                                  "seamless-m4t-medium|mini_decode"))
def test_dryrun_records(dry, pair, mesh):
    """Each pair OK on both meshes, with memory, FLOPs, bytes and
    collectives recorded; on the (2, 2) mesh the extrapolated FLOPs equal
    the full-depth trace (4 groups; zamba2 with a tail of 2, the 3-point
    fit), since eager FLOPs are exactly linear in depth."""
    rec = dry["records"][f"{pair}|{mesh}"]
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["memory"]["peak_bytes"] > 0
    assert rec["raw_cost"]["flops"] > 0 and rec["raw_cost"]["bytes"] > 0
    assert rec["raw_collectives"]["total"] > 0
    assert sum(rec["coll_by_group"].values()) == pytest.approx(
        rec["raw_collectives"]["total"])
    if mesh == "mini22":
        npts = 3 if pair.startswith("zamba2") else 2
        assert len(rec["extrapolation_points"]) == npts
        assert rec["extrapolated"]["flops"] == pytest.approx(
            rec["raw_cost"]["flops"], rel=1e-9)
    if pair.startswith("seamless"):
        assert set(rec["kernel_flops"]) == {"decode_attention",
                                            "flash_attention"}
    elif pair.startswith("zamba2"):
        assert {"ssd_intra", "ssd_intra_bwd", "flash_attention",
                "flash_attention_bwd"} <= set(rec["kernel_flops"])


def test_dryrun_sequence_parallel(dry):
    """``--seq-parallel`` traces a train step: OK, the activations'
    all-reduces now reduce-scatters and all-gathers."""
    rec = dry["records"]["qwen3-4b|mini_train|mini22|seqpar"]
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["variant"]["seq_parallel"]
    plain = dry["records"]["qwen3-4b|mini_train|mini22"]
    assert rec["raw_collectives"]["reduce-scatter"] > \
        plain["raw_collectives"]["reduce-scatter"]


def test_dryrun_records_the_expert_parallel_all_to_all(dry):
    rec = dry["records"]["deepseek-v2-236b|mini_train|mini22"]
    assert rec["variant"]["moe_shard_map"]
    assert rec["raw_collectives"]["all-to-all"] > 0


def test_fake_kernels_peak_below_the_plain_versions(dry):
    """At a sequence where the f32 scores dominate, the kernels' fake path
    (what the CUDA path allocates) peaks below the plain versions'."""
    p = dry["peaks"]
    assert 0 < p["kernel"] < p["plain"]


def test_dryrun_cli_resumes(dry):
    """A second run skips the pair already OK; ``--force`` reruns it."""
    first, second, forced = dry["cli"]
    key = "qwen3-4b|mini_train|single"
    assert f"=== {key} ===" in first and "-> OK" in first
    assert f"[skip cached] {key}" in second and "===" not in second
    assert f"=== {key} ===" in forced
    assert dry["cli_out"][key]["status"] == "OK"
