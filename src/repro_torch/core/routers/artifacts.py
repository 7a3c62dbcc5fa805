"""Fitted-router artifacts of the port, in the reference's on-disk format
(`repro.core.routers.artifacts`), so an artifact crosses between the two
packages in either direction.

Layout (one directory per artifact)::

    <path>/manifest.json   spec string, family, constructor config,
                           embedding dim, model names, fit seed, default lam,
                           dispatch policy, state checksum
    <path>/state.npz       every fitted tensor, flat keys

State keys are ``<attr>`` for plain arrays and scalars,
``<attr>/<sub>/...`` for a learned router's nested parameter tree (list
indices as decimal components: ``_params/mlp_s/0/w``, read back through
`repro_torch.models.convert.router_params_from_jax`), and ``<attr>/<field>``
for a frozen IVF / IVF-PQ index (the two field sets are disjoint, which is
how a reader tells them apart).  A streaming `DynamicIVFIndex` stores its
base under ``<attr>/base/<field>``, its delta tier verbatim
(``<attr>/delta_x``, ``<attr>/delta_assign``), its counters
(``delta_cap``, ``appends``, ``reclusters``) and the build parameters a
compaction replays (``<attr>/build/<key>``, -1 for unset); a background
compaction still running is joined before the state is read.  The writer writes format 6: both files are
published atomically through `repro_torch.persist` and the manifest carries
``state_sha256``.  The reader takes formats 1-6: a checksum is verified
where the manifest has one, and format <= 3 files, whose packed PQ lists
are row-major ``(C, L, MB)``, are transposed once to the code-major
``(C, MB, L)`` the kernels read.

A manifest's ``dispatch_policy`` loads as a `DispatchPolicy` (``None``
where the manifest has none, as format <= 4 files) and is written back
through ``to_dict``, so a policy crosses between the packages unchanged.
"""
from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np

from repro_torch import persist
from repro_torch.models.convert import router_params_from_jax
from repro_torch.kernels.knn_ivf.ops import (DynamicIVFIndex, IVFIndex,
                                             IVFPQIndex, assemble_ivf,
                                             assemble_ivfpq)
from .dispatch import DispatchPolicy
from .nn_utils import flatten_tree
from .spec import FAMILIES, router_config, spec_of

FORMAT_VERSION = 6
MIN_FORMAT_VERSION = 1


class ArtifactCorruptError(ValueError):
    """A saved artifact failed structural validation: a missing/truncated
    file, undecodable JSON/zip, or a checksum mismatch.  Carries WHICH file
    and WHICH field failed."""

    def __init__(self, path, file: str, field: str, detail: str = ""):
        self.path = Path(path)
        self.file = file
        self.field = field
        self.detail = detail
        self.reason = f"{file}[{field}]" + (f": {detail}" if detail else "")
        super().__init__(f"corrupt router artifact at {self.path} — "
                         f"{self.reason}")


_IVF_FIELDS = ("centroids", "sup_cm", "ids_cm", "inv_cm", "n_rows")
_IVFPQ_FIELDS = ("centroids", "anchors", "codes_cm", "ids_cm", "inv_cm",
                 "codebooks", "sup_flat", "n_rows", "m", "nbits")
# host mirror of each serialized index field
_HOST = {"centroids": "centroids_h", "sup_cm": "sup_h", "ids_cm": "ids_h",
         "inv_cm": "inv_h", "anchors": "anchors_h", "codes_cm": "codes_h",
         "codebooks": "codebooks_h", "sup_flat": "sup_flat_h"}
#: scalar metadata of the streaming tier; build params use -1 = "unset"
_DYN_META = ("delta_cap", "appends", "reclusters")
_DYN_BUILD_KEYS = ("n_clusters", "seed", "m", "nbits", "lane_pad")


def _scalar(arr):
    kind = arr.dtype.kind
    if kind == "b":
        return bool(arr)
    if kind in "iu":
        return int(arr)
    return float(arr)


def _collect_index(val, prefix, out):
    fields = _IVFPQ_FIELDS if isinstance(val, IVFPQIndex) else _IVF_FIELDS
    for f in fields:
        out[f"{prefix}/{f}"] = np.asarray(getattr(val, _HOST.get(f, f)))


def _collect_dynamic(val, attr, out):
    """A `DynamicIVFIndex`: base fields under ``base/``, the tier verbatim,
    counters and build parameters.  A background compaction is joined
    first (outside the lock, which its swap needs), then the fields are
    read under the lock: one consistent (base, delta) pair."""
    val.join_recluster()
    with val._lock:
        _collect_index(val.base, f"{attr}/base", out)
        out[f"{attr}/delta_x"] = np.asarray(val.delta_x, np.float32)
        out[f"{attr}/delta_assign"] = np.asarray(val.delta_assign, np.int32)
        for meta in _DYN_META:
            out[f"{attr}/{meta}"] = np.asarray(getattr(val, meta))
    for bk in _DYN_BUILD_KEYS:
        v = val.build_kw.get(bk)
        out[f"{attr}/build/{bk}"] = np.asarray(-1 if v is None else int(v))


def collect_state(router):
    """Flat ``{key: np.ndarray}`` of every fitted attribute the router's
    ``state_attrs`` declares (missing/None attributes are skipped)."""
    out = {}
    for attr in router.state_attrs:
        val = getattr(router, attr, None)
        if val is None:
            continue
        if isinstance(val, DynamicIVFIndex):
            _collect_dynamic(val, attr, out)
        elif isinstance(val, (IVFIndex, IVFPQIndex)):
            _collect_index(val, attr, out)
        elif isinstance(val, (dict, list, tuple)):
            for key, leaf in flatten_tree(val, attr).items():
                out[key] = leaf.detach().cpu().numpy()
        else:
            out[attr] = np.asarray(val)
    return out


def _restore_index(sub, device):
    """Rebuild a frozen IVF / IVF-PQ index on ``device`` from its
    serialized field set."""
    if set(sub) == set(_IVF_FIELDS):
        arrays = {f: np.asarray(sub[f]) for f in _IVF_FIELDS[:-1]}
        return assemble_ivf(**arrays, n_rows=int(sub["n_rows"]),
                            device=device)
    arrays = {f: np.asarray(sub[f]) for f in _IVFPQ_FIELDS[:-3]}
    return assemble_ivfpq(**arrays, n_rows=int(sub["n_rows"]),
                          m=int(sub["m"]), nbits=int(sub["nbits"]),
                          device=device)


def _restore_dynamic(sub, device):
    """Inverse of ``_collect_dynamic``: the base from its prefixed fields,
    then the tier, counters and build parameters (the tier's device
    buffers are built once, from the restored rows)."""
    base = {k[len("base/"):]: v for k, v in sub.items()
            if k.startswith("base/")}
    build_kw = {}
    for bk in _DYN_BUILD_KEYS:
        arr = sub.get(f"build/{bk}")
        if arr is not None and int(arr) != -1:
            build_kw[bk] = int(arr)
    dyn = DynamicIVFIndex(_restore_index(base, device),
                          delta_cap=int(sub["delta_cap"]), build_kw=build_kw)
    with dyn._lock:
        dyn.delta_x = np.asarray(sub["delta_x"], np.float32)
        dyn.delta_assign = np.asarray(sub["delta_assign"], np.int32)
        dyn.appends = int(sub["appends"])
        dyn.reclusters = int(sub["reclusters"])
        dyn._refresh()
    return dyn


def restore_state(router, state):
    """Inverse of ``collect_state``: group keys by attribute, rebuild plain
    arrays, python scalars, parameter trees and indexes on the router's
    device."""
    groups = {}
    for key, val in state.items():
        head, _, rest = key.partition("/")
        groups.setdefault(head, {})[rest] = val
    for attr, sub in groups.items():
        if attr not in router.state_attrs:
            raise ValueError(f"state entry {attr!r} is not a fitted attribute "
                             f"of {type(router).__name__}")
        if list(sub) == [""]:
            arr = sub[""]
            setattr(router, attr, _scalar(arr) if arr.ndim == 0 else arr)
        elif "delta_x" in sub:
            setattr(router, attr, _restore_dynamic(sub, router.device))
        elif set(sub) in (set(_IVF_FIELDS), set(_IVFPQ_FIELDS)):
            setattr(router, attr, _restore_index(sub, router.device))
        else:
            setattr(router, attr, router_params_from_jax(sub, router.device))
    return router


def save_router(router, path, covered_wal_seq=None) -> Path:
    """Persist a fitted router as ``manifest.json`` + ``state.npz`` under
    ``path`` (created if needed), both published atomically, the manifest
    checksumming the state.  Returns ``path``."""
    if router.model_names is None:
        raise ValueError("save_router requires a fitted router "
                         "(call .fit(ds) first)")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    bio = io.BytesIO()
    np.savez(bio, **router.state_dict())
    state_bytes = bio.getvalue()
    persist.atomic_write_bytes(path / "state.npz", state_bytes)
    manifest = {
        "format_version": FORMAT_VERSION,
        "spec": spec_of(router),
        "family": router.spec_family,
        "router_class": type(router).__name__,
        "config": router_config(router),
        "embedding_dim": router.embed_dim,
        "model_names": list(router.model_names),
        "fit_seed": router.fit_seed,
        "default_lam": router.default_lam,
        "dispatch_policy": pol.to_dict()
        if (pol := getattr(router, "dispatch_policy", None)) is not None
        else None,
        "state_sha256": persist.sha256_hex(state_bytes),
        "covered_wal_seq": covered_wal_seq,
    }
    persist.atomic_write_json(path / "manifest.json", manifest)
    return path


def _read_manifest(path: Path) -> dict:
    """Parse + structurally validate ``manifest.json``, typed errors only."""
    mf = path / "manifest.json"
    if not mf.exists():
        raise ArtifactCorruptError(path, "manifest.json", "missing",
                                   "file does not exist")
    try:
        manifest = json.loads(mf.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise ArtifactCorruptError(path, "manifest.json", "json",
                                   str(exc)) from exc
    if not isinstance(manifest, dict):
        raise ArtifactCorruptError(path, "manifest.json", "json",
                                   "top level is not an object")
    for field in ("family", "config", "model_names"):
        if field not in manifest:
            raise ArtifactCorruptError(path, "manifest.json", field,
                                       "required field missing")
    return manifest


def _read_state(path: Path, manifest: dict) -> dict:
    """Load ``state.npz`` with checksum verification where the manifest has
    one, and typed errors for every way a truncated/corrupt zip can fail."""
    sf = path / "state.npz"
    if not sf.exists():
        raise ArtifactCorruptError(path, "state.npz", "missing",
                                   "file does not exist")
    expect = manifest.get("state_sha256")
    if expect is not None and persist.sha256_file(sf) != expect:
        raise ArtifactCorruptError(
            path, "state.npz", "state_sha256",
            "checksum mismatch against the manifest — the state file is "
            "corrupt or was not written with its manifest")
    try:
        with np.load(sf) as npz:
            return {k: npz[k] for k in npz.files}
    except (zipfile.BadZipFile, ValueError, OSError, KeyError,
            EOFError) as exc:
        raise ArtifactCorruptError(path, "state.npz", "npz",
                                   f"{type(exc).__name__}: {exc}") from exc


def load_router(path, device: str = "cuda"):
    """Rebuild a fitted router from a ``save_router`` artifact (of either
    package) on ``device`` — no training data, no re-fit."""
    path = Path(path)
    manifest = _read_manifest(path)
    version = manifest.get("format_version")
    if not (isinstance(version, int)
            and MIN_FORMAT_VERSION <= version <= FORMAT_VERSION):
        raise ValueError(f"unsupported artifact format_version {version!r} "
                         f"at {path} (this build reads "
                         f"{MIN_FORMAT_VERSION}..{FORMAT_VERSION})")
    fam = FAMILIES.get(manifest["family"])
    if fam is None:
        raise ValueError(f"artifact family {manifest['family']!r} is not "
                         f"registered in this build")
    router = fam.cls(**manifest["config"], device=device)
    state = _read_state(path, manifest)
    if version < 4:
        # version<=3 packed PQ lists are row-major (C, L, MB); the kernels
        # read code-major (C, MB, L): transpose once at load
        for key in list(state):
            if key.endswith("codes_cm"):
                state[key] = np.ascontiguousarray(
                    np.swapaxes(state[key], 1, 2))
    router.load_state_dict(state)
    router.model_names = list(manifest["model_names"])
    router.embed_dim = manifest["embedding_dim"]
    router.fit_seed = manifest["fit_seed"]
    router.default_lam = float(manifest.get("default_lam", 0.0))
    pol = manifest.get("dispatch_policy")
    if pol:
        router.dispatch_policy = DispatchPolicy.from_dict(pol)
    return router
