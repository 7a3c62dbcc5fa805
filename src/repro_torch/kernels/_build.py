"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` source with a plain C interface (`KERNELS` maps
its name to the source).  On first use it is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``build/torch_kernels/`` at the root
of the checkout, named by a hash of its source and of the ``.cuh`` headers
beside it, and loaded with `ctypes`.  Nothing here runs at import time:
the CPU tests import every module on machines without ``nvcc`` or a GPU.

    python -c "from repro_torch.kernels import _build; print(_build.build_all())"
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

#: kernel name -> its source, relative to this directory
KERNELS = {"knn_topk": "knn_topk/kernel.cu",
           "flash_attention": "flash_attention/kernel.cu",
           "flash_attention_bwd": "flash_attention/bwd_kernel.cu",
           "decode_attention": "decode_attention/kernel.cu",
           "ivf_topk": "knn_ivf/kernel.cu",
           "ivfpq_adc": "knn_ivf/pq_kernel.cu",
           "ssd_intra": "ssd_scan/kernel.cu",
           "ssd_intra_bwd": "ssd_scan/bwd_kernel.cu",
           "adamw": "adamw/kernel.cu"}

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def source(name: str) -> Path:
    return _HERE / KERNELS[name]


def library_path(name: str) -> Path:
    """Build output of ``name``: its hash covers the source, every header
    of the kernels' tree (an edited header rebuilds its includers, also
    across directories) and the flags."""
    src = source(name)
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(_HERE.rglob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the process
    (or None) and the final/temporary paths."""
    out = library_path(name)
    if out.exists():
        return None, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                             str(source(name))],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, tmp


def _finish(name: str, proc, out: Path, tmp) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source(name)}:\n{log}")
    os.replace(tmp, out)
    # repro: allow-plain-write: build log beside the library, rewritten by the next build
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel not yet built, one nvcc per source, all started
    together.  Returns the wall seconds of the whole build under "total"
    and the ptxas register, shared-memory and spill report of each new
    build, each entry function's (mangled) name ahead of its report."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    logs = {n: _finish(n, *started[n]) for n in names}
    report = {"total_s": time.perf_counter() - t0}
    for n, log in logs.items():
        report[n] = [ln.strip().replace("ptxas info    : ", "")
                     for ln in log.splitlines()
                     if ("Used" in ln and "registers" in ln)
                     or "spill" in ln or "Compiling entry function" in ln]
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def sass_count(name: str, opcode: str, by_function: bool = False):
    """Instructions of kernel ``name``'s built library whose SASS opcode
    starts with ``opcode`` (e.g. "HMMA", the tensor cores' matrix multiply;
    "HMMA.16816" bf16 / fp16, "HMMA.1688" TF32), read with the toolkit's
    ``cuobjdump -sass``: their number, or with ``by_function`` a dict of
    each entry function's (mangled) name to its number."""
    load(name)
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts: Dict[str, int] = {}
    fn = ""
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts.setdefault(fn, 0)
            continue
        # "/*0130*/  [@P0] HMMA.1688.F32.TF32 R4, R8, R12, R4 ;"
        words = ln.split("*/", 1)[-1].split() if "*/" in ln else []
        if words and words[0].startswith("@"):
            words = words[1:]
        if words and words[0].startswith(opcode):
            counts[fn] = counts.get(fn, 0) + 1
    return counts if by_function else sum(counts.values())


def check(err: int, what: str) -> None:
    """Raise on a non-zero `cudaError_t` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
