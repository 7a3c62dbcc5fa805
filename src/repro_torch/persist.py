"""Crash-consistent file persistence primitives + kill-injection barriers.

Everything durable the repo writes — router artifacts, WAL segments,
training checkpoints — goes through the atomic helpers here (lint rule R6
enforces it): the bytes land in a temp file IN THE TARGET DIRECTORY, are
flushed and ``fsync``'d, then published with an atomic ``os.replace`` and a
parent-directory fsync.  A reader therefore only ever observes either the
old complete file or the new complete file — never a truncated tail — and
a SIGKILL at ANY instruction leaves at most an ignorable ``*.tmp-<pid>``
turd behind.

The kill barriers are the hooks the kill-injection harness
(`tests/test_durability.py` / `scripts/kill_injection_child.py`) drives:
``maybe_kill("name")`` SIGKILLs the current process on the Nth hit of the
named barrier when the environment carries ``REPRO_KILL_AT=<name>`` (and
optionally ``REPRO_KILL_AFTER=<n>``, default 1).  Barriers are free when
unarmed (one env lookup) and deterministic when armed — no sleeps, no
timing races: the process dies exactly at the instrumented instruction.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import signal
from pathlib import Path
from typing import Dict, Union

import numpy as np

PathLike = Union[str, os.PathLike]

# ---------------------------------------------------------------------------
# kill-injection barriers
# ---------------------------------------------------------------------------

#: per-barrier hit counters (process-local; the harness forks one process
#: per scenario, so these never need resetting)
_barrier_hits: Dict[str, int] = {}


def kill_armed(name: str) -> bool:
    """True when the environment arms barrier ``name`` and this hit reaches
    the configured threshold.  Counts the hit either way, so
    ``REPRO_KILL_AFTER=3`` dies exactly on the third crossing."""
    if os.environ.get("REPRO_KILL_AT") != name:
        return False
    after = int(os.environ.get("REPRO_KILL_AFTER", "1"))
    _barrier_hits[name] = _barrier_hits.get(name, 0) + 1
    return _barrier_hits[name] >= after


def kill_now() -> None:
    """SIGKILL the current process — no cleanup handlers, no flushing, the
    closest a test harness gets to a power cut."""
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_kill(name: str) -> None:
    """Crash barrier: die here iff the environment arms ``name``."""
    if kill_armed(name):
        kill_now()


# ---------------------------------------------------------------------------
# atomic writes
# ---------------------------------------------------------------------------

def fsync_dir(path: PathLike) -> None:
    """fsync a DIRECTORY so a just-renamed entry survives a crash (the
    rename itself is atomic, but its durability needs the dir synced)."""
    fd = os.open(os.fspath(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass    # some filesystems refuse directory fsync; rename still atomic
    finally:
        os.close(fd)


def atomic_write_bytes(path: PathLike, data: bytes, *,
                       fsync: bool = True) -> Path:
    """Publish ``data`` at ``path`` atomically: temp file in the same
    directory -> write -> flush -> fsync -> ``os.replace`` -> dir fsync.
    Readers never observe a partial file; a crash leaves only a
    ``*.tmp-<pid>`` file that scanners ignore."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
    # repro: allow-plain-write: this IS the atomic helper — the plain write
    # targets the temp name, never the final path
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    maybe_kill("atomic-pre-rename")
    os.replace(tmp, path)
    if fsync:
        fsync_dir(path.parent)
    maybe_kill("atomic-post-rename")
    return path


def atomic_write_text(path: PathLike, text: str, *,
                      fsync: bool = True) -> Path:
    return atomic_write_bytes(path, text.encode("utf-8"), fsync=fsync)


def atomic_write_json(path: PathLike, obj, *, indent: int = 2,
                      fsync: bool = True) -> Path:
    return atomic_write_text(path, json.dumps(obj, indent=indent) + "\n",
                             fsync=fsync)


def atomic_savez(path: PathLike, *, fsync: bool = True,
                 **arrays) -> Path:
    """``np.savez`` with atomic publication: the zip is assembled in memory
    and lands via `atomic_write_bytes`, so a crashed save can never leave a
    truncated npz at the final path."""
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    return atomic_write_bytes(path, bio.getvalue(), fsync=fsync)


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: PathLike) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
