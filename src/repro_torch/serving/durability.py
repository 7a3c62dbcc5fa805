"""Durable online-index state of the port (mirrors
`repro.serving.durability`): a write-ahead feedback log and crash-consistent
checkpoints, so every acknowledged ``observe()`` batch survives a crash and
a restart resumes where the process died.

* `WriteAheadLog` — append-only segment files of framed records
  (``RWAL | u32 payload_len | u64 seq | u32 crc32 | npz payload``), each
  flushed and fsync'd before the caller applies the batch.  The frame and
  the npz payload are the reference's, so a log written by either package
  reads in the other (the same records give the same bytes, up to the
  timestamp the zip format stamps on each payload).  Replay drops a torn
  tail (a record cut short by SIGKILL) and truncates the segment back to
  its last complete record; a bad record FOLLOWED by valid data is
  corruption (`WALCorruptError`).
* `CheckpointStore` — artifact-format snapshots (the port's `save_router`)
  written to ``ckpt-<n>.tmp-<pid>`` and published with an atomic directory
  rename and a parent fsync; each manifest records the WAL sequence it
  covers.  A corrupt published snapshot (`ArtifactCorruptError`) is skipped
  in favour of the previous one.
* `DurabilityManager` — log -> apply -> maybe checkpoint (on a batch
  cadence, or after a compaction asked for one), WAL pruning, and the
  counters ``/stats`` serves.

Recovery = the newest valid checkpoint + the WAL records after its
coverage, replayed through ``partial_fit`` with the same batch boundaries.
A compaction is seed-deterministic (bitwise equal to a fresh build over the
same rows), so the recovered router has the uncrashed process's support
size and its retrieval bits.
"""
from __future__ import annotations

import io
import os
import shutil
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch import persist
from repro_torch.core.routers.artifacts import (ArtifactCorruptError,
                                                load_router, save_router)

_MAGIC = b"RWAL"
#: record header: magic, payload byte length, sequence number, payload CRC32
_HEADER = struct.Struct("<4sIQI")

_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"
_CKPT_PREFIX = "ckpt-"


class WALCorruptError(RuntimeError):
    """A WAL record failed its frame/CRC check somewhere OTHER than the
    torn tail — data after it would be lost, so replay refuses to guess."""

    def __init__(self, path: Path, offset: int, detail: str):
        super().__init__(f"corrupt WAL record in {path} at byte {offset}: "
                         f"{detail}")
        self.path = Path(path)
        self.offset = int(offset)
        self.detail = detail


@dataclass
class WALRecord:
    seq: int
    emb: np.ndarray
    scores: np.ndarray
    costs: np.ndarray


def _encode_payload(emb, scores, costs) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, emb=np.asarray(emb, np.float32),
             scores=np.asarray(scores, np.float32),
             costs=np.asarray(costs, np.float32))
    return bio.getvalue()


def _decode_payload(seq: int, payload: bytes) -> WALRecord:
    with np.load(io.BytesIO(payload)) as npz:
        return WALRecord(seq=seq, emb=npz["emb"], scores=npz["scores"],
                         costs=npz["costs"])


class WriteAheadLog:
    """Append-only framed-record log over segment files in one directory.

    ``append`` returns only after the record bytes are flushed and (with
    ``fsync=True``, the default) fsync'd — the caller's acknowledgment
    point.  Everything before that instant survives SIGKILL; a record cut
    by the kill is dropped at replay as the torn tail."""

    def __init__(self, dir: os.PathLike, *, segment_max_bytes: int = 4 << 20,
                 fsync: bool = True):
        self.dir = Path(dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_max_bytes = int(segment_max_bytes)
        self.fsync = bool(fsync)
        self.appended = 0            # records appended by THIS process
        self.torn_tail_dropped = 0   # torn records repaired at open
        self._f = None               # current segment file object
        self._f_size = 0
        self.next_seq = self._repair()

    # ---- segment inventory ----
    def _segments(self) -> List[Tuple[int, Path]]:
        """(first_seq, path) of every published segment, ascending."""
        out = []
        for p in self.dir.iterdir():
            name = p.name
            if (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)
                    and ".tmp-" not in name):
                try:
                    out.append((int(name[len(_SEG_PREFIX):
                                         -len(_SEG_SUFFIX)]), p))
                except ValueError:  # repro: allow-swallow: foreign file in the WAL dir, not a segment
                    continue
        return sorted(out)

    def _repair(self) -> int:
        """Scan every record once, truncate a torn tail off the LAST
        segment (so later appends never follow garbage), and return the
        next sequence number."""
        last_seq = -1
        segments = self._segments()
        for si, (first_seq, path) in enumerate(segments):
            is_last = si == len(segments) - 1
            valid_end, seqs = self._scan_segment(path, is_last=is_last)
            if seqs:
                last_seq = seqs[-1]
            if valid_end < path.stat().st_size:
                # torn tail from a crash mid-append: drop it — those bytes
                # were never acknowledged — and truncate so the next append
                # (and the next replay) continue from a clean end
                self.torn_tail_dropped += 1
                # repro: allow-plain-write: in-place truncate IS the repair
                with open(path, "rb+") as f:
                    f.truncate(valid_end)
                    if self.fsync:
                        os.fsync(f.fileno())
        return last_seq + 1

    def _scan_segment(self, path: Path, *,
                      is_last: bool) -> Tuple[int, List[int]]:
        """(byte offset of the last complete record's end, seqs found).
        A broken record at the physical tail of the last segment is
        tolerated; anywhere else it is `WALCorruptError`."""
        seqs: List[int] = []
        offset = 0
        data = path.read_bytes()
        size = len(data)
        while offset < size:
            torn = None
            if offset + _HEADER.size > size:
                torn = "truncated header"
            else:
                magic, plen, seq, crc = _HEADER.unpack_from(data, offset)
                if magic != _MAGIC:
                    torn = f"bad magic {magic!r}"
                elif offset + _HEADER.size + plen > size:
                    torn = f"truncated payload ({plen} bytes declared)"
                else:
                    payload = data[offset + _HEADER.size:
                                   offset + _HEADER.size + plen]
                    if zlib.crc32(payload) != crc:
                        torn = "payload CRC mismatch"
            if torn is not None:
                if is_last:
                    return offset, seqs
                raise WALCorruptError(path, offset, torn)
            seqs.append(seq)
            offset += _HEADER.size + plen
        return offset, seqs

    # ---- append ----
    def _segment_file(self, record_len: int):
        """Current segment file, rotating once it exceeds the size cap.
        Named by the first seq it holds; re-opened ``ab`` so a repaired
        (truncated) segment keeps its name."""
        if self._f is not None and \
                self._f_size + record_len > self.segment_max_bytes and \
                self._f_size > 0:
            self._f.close()
            self._f = None
        if self._f is None:
            path = self.dir / (f"{_SEG_PREFIX}{self.next_seq:012d}"
                               f"{_SEG_SUFFIX}")
            # WAL segments are append-only by design — atomicity is
            # per-record (CRC frame + torn-tail drop), not per-file;
            # rename-publishing would break incremental fsync.
            # repro: allow-plain-write: append-only WAL segment, per-record CRC framing
            self._f = open(path, "ab")
            self._f_size = self._f.tell()
            persist.fsync_dir(self.dir)    # the new NAME must be durable too
        return self._f

    def append(self, emb, scores, costs) -> int:
        """Frame, write, flush, fsync ONE observation batch; returns its
        sequence number.  Only after this returns may the caller apply the
        batch to the live index — that ordering is the whole durability
        contract."""
        payload = _encode_payload(emb, scores, costs)
        seq = self.next_seq
        record = _HEADER.pack(_MAGIC, len(payload), seq,
                              zlib.crc32(payload)) + payload
        f = self._segment_file(len(record))
        if persist.kill_armed("wal-mid-record"):
            # harness barrier: die with half a record on disk — replay must
            # drop exactly this tail
            f.write(record[:_HEADER.size + max(1, len(payload) // 2)])
            f.flush()
            persist.kill_now()
        f.write(record)
        f.flush()
        persist.maybe_kill("wal-pre-fsync")
        if self.fsync:
            os.fsync(f.fileno())
        persist.maybe_kill("wal-post-fsync")
        self._f_size += len(record)
        self.next_seq = seq + 1
        self.appended += 1
        return seq

    # ---- replay ----
    def records(self, after_seq: int = -1) -> Iterator[WALRecord]:
        """Yield every intact record with ``seq > after_seq`` in order.
        (`_repair` already dropped any torn tail at open.)"""
        for _, path in self._segments():
            data = path.read_bytes()
            offset, size = 0, len(data)
            while offset + _HEADER.size <= size:
                magic, plen, seq, crc = _HEADER.unpack_from(data, offset)
                end = offset + _HEADER.size + plen
                if magic != _MAGIC or end > size:
                    break              # repaired tail remnant; nothing after
                payload = data[offset + _HEADER.size:end]
                if zlib.crc32(payload) != crc:
                    break
                if seq > after_seq:
                    yield _decode_payload(seq, payload)
                offset = end
    # ---- maintenance ----

    def prune(self, covered_seq: int) -> int:
        """Delete segments whose records are ALL covered by a durable
        checkpoint.  A segment is removable when the NEXT segment starts at
        or below ``covered_seq + 1`` (so every record it holds is covered);
        the active tail segment always stays."""
        segments = self._segments()
        removed = 0
        for (first, path), (next_first, _) in zip(segments, segments[1:]):
            if next_first <= covered_seq + 1:
                if self._f is not None and Path(self._f.name) == path:
                    continue
                path.unlink()
                removed += 1
        if removed:
            persist.fsync_dir(self.dir)
        return removed

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def stats(self) -> dict:
        segments = self._segments()
        return {
            "next_seq": self.next_seq,
            "appended": self.appended,
            "torn_tail_dropped": self.torn_tail_dropped,
            "segments": len(segments),
            "bytes": sum(p.stat().st_size for _, p in segments),
            "fsync": self.fsync,
        }


class CheckpointStore:
    """Atomic artifact-format snapshots, one directory per checkpoint.

    ``ckpt-<n>`` covers WAL sequences ``[0, n)`` (``covered_wal_seq =
    n - 1``; ``n = 0`` is the bootstrap snapshot).  The artifact is written
    under a ``.tmp-<pid>`` name and published with one atomic rename, so a
    scanner can trust every published directory to be complete — corrupt
    contents (a flipped bit, a truncated npz) are still caught by the
    manifest checksum at load and skipped."""

    def __init__(self, dir: os.PathLike, device: str = "cuda"):
        self.dir = Path(dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        #: device the loaded checkpoints' routers serve on
        self.device = device

    def list(self) -> List[Tuple[int, Path]]:
        """(covered_seq, path) of published checkpoints, NEWEST first."""
        out = []
        for p in self.dir.iterdir():
            name = p.name
            if (name.startswith(_CKPT_PREFIX) and ".tmp-" not in name
                    and p.is_dir()):
                try:
                    out.append((int(name[len(_CKPT_PREFIX):]) - 1, p))
                except ValueError:  # repro: allow-swallow: foreign dir, not a checkpoint
                    continue
        return sorted(out, reverse=True)

    def save(self, router, covered_seq: int) -> Path:
        n = covered_seq + 1
        final = self.dir / f"{_CKPT_PREFIX}{n:012d}"
        tmp = self.dir / f"{_CKPT_PREFIX}{n:012d}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        save_router(router, tmp, covered_wal_seq=covered_seq)
        persist.maybe_kill("ckpt-pre-rename")
        if final.exists():           # re-checkpoint at the same coverage
            shutil.rmtree(final)
        os.replace(tmp, final)
        persist.fsync_dir(self.dir)
        persist.maybe_kill("ckpt-post-rename")
        return final

    def load_latest(self):
        """(router, covered_seq, corrupt_paths_skipped) from the newest
        loadable checkpoint; (None, -1, skipped) when none exists.  A
        checkpoint that fails its checksum/format validation is skipped in
        favour of the previous one — never loaded."""
        skipped: List[str] = []
        for covered_seq, path in self.list():
            try:
                return (load_router(path, device=self.device), covered_seq,
                        skipped)
            except ArtifactCorruptError as exc:
                skipped.append(f"{path.name}: {exc.reason}")
        return None, -1, skipped

    def prune(self, keep: int = 2) -> int:
        """Drop all but the newest ``keep`` checkpoints (and any stale
        ``.tmp-*`` turds from crashed saves)."""
        removed = 0
        for _, path in self.list()[keep:]:
            shutil.rmtree(path)
            removed += 1
        for p in self.dir.iterdir():
            if ".tmp-" in p.name and p.is_dir():
                shutil.rmtree(p)
                removed += 1
        if removed:
            persist.fsync_dir(self.dir)
        return removed


class DurabilityManager:
    """The serving-side durability policy around one router.

    ``log -> apply -> note_applied -> maybe checkpoint``: `RouterService.
    observe` calls `log` (fsync ack) BEFORE `partial_fit`, then
    `note_applied`; `should_checkpoint` fires on the batch cadence or when
    a background re-cluster requested one (`request_checkpoint` — set from
    the compaction thread, acted on from the serving thread, so the
    checkpoint's `join_recluster` can never join its own thread).
    `checkpoint` snapshots the router, records coverage, prunes covered WAL
    segments and old snapshots."""

    def __init__(self, root: os.PathLike, *, checkpoint_every: int = 16,
                 segment_max_bytes: int = 4 << 20, fsync: bool = True,
                 keep_checkpoints: int = 2, device: str = "cuda"):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.wal = WriteAheadLog(self.root / "wal",
                                 segment_max_bytes=segment_max_bytes,
                                 fsync=fsync)
        self.checkpoints = CheckpointStore(self.root / "checkpoints",
                                           device=device)
        self.checkpoint_every = int(checkpoint_every)
        self.keep_checkpoints = int(keep_checkpoints)
        #: serializes log+apply+checkpoint against concurrent observers
        self.mutex = threading.RLock()
        self.applied_seq = -1        # newest seq applied to the live index
        self.covered_seq = -1        # newest seq covered by a checkpoint
        self.batches_since_checkpoint = 0
        self.checkpoints_written = 0
        self.checkpoint_pending = False
        self.last_checkpoint_at: Optional[float] = None
        self.last_append_at: Optional[float] = None

    # ---- observe-path hooks ----
    def log(self, emb, scores, costs) -> int:
        seq = self.wal.append(emb, scores, costs)
        self.last_append_at = time.time()
        return seq

    def note_applied(self, seq: int) -> None:
        self.applied_seq = seq
        self.batches_since_checkpoint += 1

    def request_checkpoint(self) -> None:
        """Recluster hook target: only sets a flag — the next observe (or an
        explicit `checkpoint`) performs the snapshot on the serving thread."""
        self.checkpoint_pending = True

    def should_checkpoint(self) -> bool:
        return (self.checkpoint_pending
                or (self.checkpoint_every > 0
                    and self.batches_since_checkpoint
                    >= self.checkpoint_every))

    def checkpoint(self, router) -> Path:
        """Snapshot the router covering everything applied so far, then
        prune WAL segments and old snapshots that coverage obsoletes."""
        with self.mutex:
            seq = self.applied_seq
            path = self.checkpoints.save(router, seq)
            self.covered_seq = seq
            self.batches_since_checkpoint = 0
            self.checkpoint_pending = False
            self.checkpoints_written += 1
            self.last_checkpoint_at = time.time()
            self.checkpoints.prune(self.keep_checkpoints)
            # belt and braces: keep WAL coverage back to the OLDEST retained
            # snapshot, so even a corrupt newest checkpoint (skipped at
            # recovery) still replays to the identical state from the
            # previous one
            retained = self.checkpoints.list()
            if retained:
                self.wal.prune(retained[-1][0])
            return path

    # ---- recovery ----
    def load_latest_checkpoint(self):
        """(router-or-None, covered_seq, corrupt-skips); aligns the applied/
        covered cursors with the loaded snapshot."""
        router, covered_seq, skipped = self.checkpoints.load_latest()
        with self.mutex:
            self.applied_seq = covered_seq
            self.covered_seq = covered_seq
        return router, covered_seq, skipped

    def pending_records(self) -> List[WALRecord]:
        """WAL suffix not covered by the loaded checkpoint, replay order."""
        return list(self.wal.records(after_seq=self.covered_seq))

    def close(self) -> None:
        self.wal.close()

    def stats(self) -> dict:
        now = time.time()
        return {
            "wal": {
                **self.wal.stats(),
                "applied_seq": self.applied_seq,
                "last_append_age_s": (None if self.last_append_at is None
                                      else now - self.last_append_at),
            },
            "checkpoints": {
                "covered_seq": self.covered_seq,
                "on_disk": len(self.checkpoints.list()),
                "written": self.checkpoints_written,
                "pending": self.checkpoint_pending,
                "every_batches": self.checkpoint_every,
                "batches_since": self.batches_since_checkpoint,
                "last_age_s": (None if self.last_checkpoint_at is None
                               else now - self.last_checkpoint_at),
            },
        }
