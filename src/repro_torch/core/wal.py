"""Durability layer: the commit log, snapshots and the manifest.

A detection service (``core/serving.py``) that is given a state directory
makes each corpus mutation survive the process:

  * ``CommitLog`` — an append-only, schema-versioned, checksummed log with
    one record per ``DetectionService.commit()`` or ``retract()``, fsync'd
    before the call returns under the default ``fsync="commit"``. A commit
    record carries the accepted rows (values/accuracy/p_claim), the rows'
    touched claim keys, the post-commit epoch, the compaction marker and
    the owner row range. Reading stops at the first invalid record (short
    header, bad magic, short payload, CRC mismatch) and ``recover``
    truncates the file back to the last valid record — the torn tail a
    SIGKILL mid-write leaves loses only the commit that was never
    acknowledged.
  * Snapshots — periodic serializations of the full service state
    (resident corpus, committed index via ``InvertedIndex.state_dict``,
    epoch, touched-key log, result-cache entries, stats counters) in the
    framed container: one header (magic, version, payload length, CRC32)
    and an npz payload, written through a temp file and ``os.replace``.
    ``latest_valid_snapshot`` walks candidates newest-first and skips
    corrupt files. The spilled chunks of ``core/shardplan.py`` reuse the
    container under their own magic.
  * The manifest — the JSON config a restore rebuilds the service from.
  * ``DurabilityOptions`` — the per-service knobs.

The byte layout of all three is the JAX package's (``repro.core.wal``), so
a log, a snapshot or a manifest written by either package reads back in the
other.
"""
from __future__ import annotations

import io
import json
import os
import re
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

#: Log-record schema version. Readers reject records from a NEWER major
#: version (they cannot know the framing changed compatibly); bump when the
#: record payload keys or header layout change.
WAL_VERSION = 1

#: Snapshot container version — versions the FRAME (header + npz payload
#: envelope). The payload's store chunk layout carries its own version
#: (``store.STORE_LAYOUT_VERSION``) so the two can evolve independently.
SNAPSHOT_VERSION = 1

#: Manifest schema version (the small JSON file describing the service).
MANIFEST_VERSION = 1

_REC_MAGIC = b"CDWR"            # per-record magic, commit log
_SNAP_MAGIC = b"CDSN"           # snapshot file magic
SPILL_MAGIC = b"CDSP"           # spilled-chunk file magic (core/shardplan.py)
#: Record header: magic, version u16, record type u16, payload bytes u32,
#: CRC32 of the payload u32 — 16 bytes, little-endian.
_REC_HEADER = struct.Struct("<4sHHII")
#: Snapshot header: magic, version u16, reserved u16, payload bytes u64,
#: CRC32 of the payload u32 — 20 bytes, little-endian.
_SNAP_HEADER = struct.Struct("<4sHHQI")

#: Record types. The type field lets markers (retraction, shard handoff)
#: extend the log without re-versioning; readers skip unknown types.
REC_COMMIT = 1
REC_RETRACT = 2

LOG_NAME = "commits.wal"
MANIFEST_NAME = "manifest.json"
_SNAP_RE = re.compile(r"^snapshot-(\d{8})\.snap$")


class WalError(RuntimeError):
    """Base class for durability-layer failures."""


class ReplayDivergenceError(WalError):
    """Replaying a log record did not reproduce the recorded outcome.

    Raised by ``DetectionService.restore`` when a replayed commit lands on a
    different epoch or compaction outcome than the record logged — the
    deterministic-replay invariant (DESIGN.md §8) is broken, so serving from
    this state would silently diverge from the pre-crash service.
    """


class NoValidSnapshotError(WalError):
    """A restore found no loadable snapshot in the state dir."""


@dataclass(frozen=True)
class DurabilityOptions:
    """Config for a durable ``DetectionService`` (all knobs in one place)."""

    # Directory holding the manifest, the commit log, and the snapshots.
    # One service per state dir — concurrent writers would interleave log
    # records. ``ReplicaRouter`` derives per-replica ``replica-<i>/``
    # subdirectories automatically.
    state_dir: str
    # Snapshot cadence in commits: a snapshot is written after every commit
    # whose post-commit epoch is a multiple of this. 0 disables periodic
    # snapshots (only the initial epoch-0 snapshot is written — restore then
    # replays the whole log; the durability benchmark uses this to measure
    # the raw replay rate). Smaller values shorten restore at the cost of
    # snapshot write time (O(corpus bytes)) on the commit path.
    snapshot_every: int = 16
    # fsync policy for log appends: "commit" fsyncs after every record —
    # a commit is durable the moment ``commit()`` returns; "none" leaves
    # flushing to the OS page cache — faster, but commits since the last
    # OS flush can vanish on power loss (a clean process kill still keeps
    # them; torn-tail recovery handles either case).
    fsync: str = "commit"
    # Number of snapshot files kept on disk. Older snapshots are pruned
    # after each successful write; ≥ 2 keeps a fallback if the newest file
    # is corrupt. The commit log itself is never pruned (see OPERATIONS.md
    # for disk-space expectations).
    retention: int = 2


@dataclass
class RecoveryInfo:
    """What log recovery found (and possibly discarded) on open."""

    records: int                  # valid records in the log
    valid_bytes: int              # log length after truncating the torn tail
    discarded_bytes: int = 0      # torn/corrupt tail bytes dropped


@dataclass
class RestoreInfo:
    """Receipt of one ``DetectionService.restore`` (timings + provenance)."""

    snapshot_epoch: int           # epoch of the snapshot that seeded state
    snapshot_path: str            # file the state was loaded from
    replayed_commits: int         # log records applied on top of it
    discarded_bytes: int          # torn-tail bytes dropped by log recovery
    skipped_snapshots: int = 0    # corrupt snapshot files skipped
    snapshot_load_s: float = 0.0  # wall time to load + deserialize
    replay_s: float = 0.0         # wall time replaying the log tail
    wall_s: float = 0.0           # total restore wall time


def _encode_arrays(arrays: dict) -> bytes:
    """Serialize a ``{name: ndarray}`` dict to npz bytes (the one payload
    codec shared by log records and snapshots)."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _decode_arrays(payload: bytes) -> dict:
    """Inverse of ``_encode_arrays`` (materialized — no open file handles)."""
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@dataclass
class CommitRecord:
    """One decoded commit-log record (see ``CommitLog`` for the framing)."""

    rec_type = REC_COMMIT         # header type field for this record class

    epoch: int                    # service epoch AFTER this commit applied
    values: np.ndarray            # (q, D) int32 — the accepted rows
    accuracy: np.ndarray          # (q,) float32
    p_claim: np.ndarray           # (q, D) float32
    touched_keys: np.ndarray      # sorted int64 claim keys of the rows
    compact: bool                 # the compact= flag the commit ran with
    compacted: bool               # compaction marker: did deltas fold back?
    # Shard-owner routing (DESIGN.md §12): the corpus row range [lo, hi)
    # these rows landed in, so a restoring owner replica knows whether the
    # record mutates ITS index slice or only the shared claims state.
    # -1/-1 = unscoped (single-host service or pre-§12 log).
    owner_lo: int = -1
    owner_hi: int = -1

    def payload(self) -> bytes:
        """Encode this record's fields to the framed npz payload."""
        return _encode_arrays({
            "values": np.asarray(self.values, np.int32),
            "accuracy": np.asarray(self.accuracy, np.float32),
            "p_claim": np.asarray(self.p_claim, np.float32),
            "touched_keys": np.asarray(self.touched_keys, np.int64),
            "meta": np.array([self.epoch, int(self.compact),
                              int(self.compacted), self.owner_lo,
                              self.owner_hi], np.int64),
        })

    @classmethod
    def from_payload(cls, payload: bytes) -> "CommitRecord":
        """Decode a framed npz payload back into a record."""
        d = _decode_arrays(payload)
        meta = d["meta"]
        # Older logs carry a 3-int meta (no owner range) — decode as -1/-1.
        lo, hi = (int(meta[3]), int(meta[4])) if len(meta) >= 5 else (-1, -1)
        return cls(epoch=int(meta[0]), values=d["values"],
                   accuracy=d["accuracy"], p_claim=d["p_claim"],
                   touched_keys=d["touched_keys"], compact=bool(meta[1]),
                   compacted=bool(meta[2]), owner_lo=lo, owner_hi=hi)


@dataclass
class RetractRecord:
    """One decoded retraction record (``REC_RETRACT``, DESIGN.md §9).

    A retraction drops committed sources; replay applies it through the
    exact live path (``DetectionService._retract_locked``), so the record
    only needs the row identities — ``row_ids`` in the corpus row coordinates
    of the PRE-retraction epoch — plus the invariants replay asserts against
    (``n_before``) and the invalidation currency (``touched_keys``).
    """

    rec_type = REC_RETRACT        # header type field for this record class

    epoch: int                    # service epoch AFTER this retraction
    row_ids: np.ndarray           # (k,) int64 — retracted corpus rows
    touched_keys: np.ndarray      # sorted int64 claim keys of those rows
    n_before: int                 # corpus rows BEFORE the retraction
    # Shard-owner routing (DESIGN.md §12): the [lo, hi) row span covering
    # the retracted ids; -1/-1 = unscoped (see CommitRecord).
    owner_lo: int = -1
    owner_hi: int = -1

    def payload(self) -> bytes:
        """Encode this record's fields to the framed npz payload."""
        return _encode_arrays({
            "row_ids": np.asarray(self.row_ids, np.int64),
            "touched_keys": np.asarray(self.touched_keys, np.int64),
            "meta": np.array([self.epoch, self.n_before, self.owner_lo,
                              self.owner_hi], np.int64),
        })

    @classmethod
    def from_payload(cls, payload: bytes) -> "RetractRecord":
        """Decode a framed npz payload back into a record."""
        d = _decode_arrays(payload)
        meta = d["meta"]
        lo, hi = (int(meta[2]), int(meta[3])) if len(meta) >= 4 else (-1, -1)
        return cls(epoch=int(meta[0]), row_ids=d["row_ids"],
                   touched_keys=d["touched_keys"], n_before=int(meta[1]),
                   owner_lo=lo, owner_hi=hi)


class CommitLog:
    """The append-only commit log (one file, ``commits.wal``).

    Record framing (little-endian)::

        ┌──────────┬─────────┬────────┬─────────┬───────┬─────────────┐
        │ magic    │ version │ type   │ length  │ crc32 │ payload     │
        │ "CDWR"   │ u16     │ u16    │ u32     │ u32   │ npz bytes   │
        └──────────┴─────────┴────────┴─────────┴───────┴─────────────┘

    Appends are atomic at the record level through the CRC: a reader accepts
    a record only when the header parses, the payload is fully present, and
    its CRC32 matches — anything else is a torn tail and reading stops at
    the last valid record boundary. ``fsync="commit"`` makes each append
    durable before ``append`` returns.
    """

    def __init__(self, path: str, fsync: str = "commit"):
        """Open (creating if absent) the log at ``path`` for appending.

        The caller should run ``CommitLog.recover(path)`` first when the
        file may carry a torn tail (restore does) — appending after a torn
        tail would bury the corruption mid-file.
        """
        if fsync not in ("commit", "none"):
            raise ValueError(f"fsync must be 'commit' or 'none', got {fsync!r}")
        self.path = path
        self.fsync = fsync
        self._f = open(path, "ab")
        self._last_offset: Optional[int] = None

    def append(self, record) -> int:
        """Append one record (``CommitRecord`` or ``RetractRecord``); returns
        bytes written. Durable per the fsync policy before returning (the
        mutation's durability point)."""
        payload = record.payload()
        header = _REC_HEADER.pack(_REC_MAGIC, WAL_VERSION, record.rec_type,
                                  len(payload), zlib.crc32(payload))
        self._last_offset = self._f.tell()
        self._f.write(header)
        self._f.write(payload)
        self._f.flush()
        if self.fsync == "commit":
            os.fsync(self._f.fileno())
        return len(header) + len(payload)

    def rollback_last(self) -> None:
        """Truncate the record appended by the LAST ``append`` on this handle.

        The log-side half of ``DetectionService.rollback_last_commit`` (LIFO,
        like ``rollback_commit``): the router's broadcast recovery must not
        leave a record for a commit it rolled back, or a restore would
        replay it. Only the immediately-preceding append can be unwound.
        """
        if self._last_offset is None:
            raise WalError("no append to roll back on this log handle")
        self._f.truncate(self._last_offset)
        self._f.seek(self._last_offset)
        if self.fsync == "commit":
            os.fsync(self._f.fileno())
        self._last_offset = None

    def close(self) -> None:
        """Close the underlying file handle."""
        self._f.close()

    # -- reading ------------------------------------------------------------

    @staticmethod
    def scan(path: str) -> tuple[list, int, int]:
        """Parse the log: ``(records, valid_bytes, discarded_bytes)``.

        Reads records until EOF or the first invalid one (short header, bad
        magic, newer version, short payload, CRC mismatch). ``valid_bytes``
        is the offset of the last valid record boundary; everything after it
        counts as ``discarded_bytes`` — the torn tail a crash mid-append (or
        mid-payload flush) leaves behind. Missing file ⇒ ``([], 0, 0)``.
        """
        records: list = []
        if not os.path.exists(path):
            return records, 0, 0
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        n = len(data)
        while off + _REC_HEADER.size <= n:
            magic, version, rec_type, length, crc = _REC_HEADER.unpack_from(
                data, off)
            if magic != _REC_MAGIC or version > WAL_VERSION:
                break
            start = off + _REC_HEADER.size
            end = start + length
            if end > n:
                break
            payload = data[start:end]
            if zlib.crc32(payload) != crc:
                break
            if rec_type == REC_COMMIT:
                records.append(CommitRecord.from_payload(payload))
            elif rec_type == REC_RETRACT:
                records.append(RetractRecord.from_payload(payload))
            # unknown record types from same-version writers are skipped,
            # not fatal — forward-compatible markers
            off = end
        return records, off, n - off

    @staticmethod
    def recover(path: str) -> RecoveryInfo:
        """Truncate the log to its last valid record; returns what happened.

        Idempotent; a no-op on a clean log or a missing file. This is the
        torn-tail recovery step ``DetectionService.restore`` runs before
        replaying and before reopening the log for appends.
        """
        records, valid, discarded = CommitLog.scan(path)
        if discarded:
            with open(path, "rb+") as f:
                f.truncate(valid)
        return RecoveryInfo(records=len(records), valid_bytes=valid,
                            discarded_bytes=discarded)

    @staticmethod
    def read(path: str) -> Iterator:
        """Iterate the valid records of the log (torn tail silently ignored —
        run ``recover`` first when the truncation must be made durable)."""
        records, _, _ = CommitLog.scan(path)
        return iter(records)


# ---------------------------------------------------------------------------
# Framed containers (snapshots + spilled shard chunks share one format)
# ---------------------------------------------------------------------------

def write_framed(path: str, arrays: dict, magic: bytes = _SNAP_MAGIC,
                 version: int = SNAPSHOT_VERSION, fsync: bool = True) -> str:
    """Atomically write a checksummed framed npz container at ``path``.

    One header (magic, version, payload length, CRC32) followed by the npz
    payload — the same frame snapshots use, parameterized on ``magic`` so
    other single-blob files (``core/shardplan.py``'s spilled chunks) reuse
    the torn-write/bit-rot detection instead of inventing a format. The
    write goes through a temp file + ``os.replace`` so a crash mid-write
    never leaves a half-written file under the canonical name. Returns
    ``path``.
    """
    payload = _encode_arrays(arrays)
    header = _SNAP_HEADER.pack(magic, version, 0,
                               len(payload), zlib.crc32(payload))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(payload)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_framed(path: str, magic: bytes = _SNAP_MAGIC,
                version: int = SNAPSHOT_VERSION) -> dict:
    """Load one framed container; raises ``WalError`` when the frame is
    invalid (bad magic, newer version, truncation, CRC mismatch)."""
    with open(path, "rb") as f:
        header = f.read(_SNAP_HEADER.size)
        if len(header) < _SNAP_HEADER.size:
            raise WalError(f"{path}: truncated frame header")
        got_magic, got_version, _, length, crc = _SNAP_HEADER.unpack(header)
        if got_magic != magic:
            raise WalError(f"{path}: bad frame magic {got_magic!r}")
        if got_version > version:
            raise WalError(
                f"{path}: frame version {got_version} is newer than this "
                f"reader ({version})")
        payload = f.read(length)
    if len(payload) < length:
        raise WalError(f"{path}: truncated frame payload")
    if zlib.crc32(payload) != crc:
        raise WalError(f"{path}: frame checksum mismatch")
    return _decode_arrays(payload)


# ---------------------------------------------------------------------------
# Snapshots
# ---------------------------------------------------------------------------

def snapshot_path(state_dir: str, epoch: int) -> str:
    """Canonical snapshot filename for a given epoch."""
    return os.path.join(state_dir, f"snapshot-{epoch:08d}.snap")


def write_snapshot(state_dir: str, epoch: int, arrays: dict,
                   retention: int = 0) -> str:
    """Serialize ``arrays`` as the epoch's snapshot file, atomically.

    A ``write_framed`` container (``SNAPSHOT_VERSION`` + CRC32) under the
    canonical epoch filename; ``retention > 0`` prunes older snapshots down
    to that many afterwards. Returns the written path.
    """
    path = write_framed(snapshot_path(state_dir, epoch), arrays)
    if retention > 0:
        for _, old in list_snapshots(state_dir)[:-retention]:
            try:
                os.remove(old)
            except OSError:
                pass
    return path


def load_snapshot(path: str) -> dict:
    """Load one snapshot file; raises ``WalError`` when the frame is invalid
    (bad magic, newer version, truncation, CRC mismatch)."""
    return load_framed(path)


def list_snapshots(state_dir: str) -> list:
    """``[(epoch, path)]`` of snapshot files present, sorted by epoch."""
    out = []
    for name in os.listdir(state_dir):
        m = _SNAP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(state_dir, name)))
    return sorted(out)


def latest_valid_snapshot(state_dir: str) -> tuple[int, str, dict, int]:
    """Newest snapshot that loads cleanly: ``(epoch, path, arrays, skipped)``.

    Walks candidates newest-first, skipping any file whose frame fails to
    validate (``skipped`` counts them) — a crash between snapshot writes or
    a bit-rotted newest file falls back to the previous one, whose log tail
    is still replayable because the log is never pruned. Raises
    ``NoValidSnapshotError`` when nothing loads.
    """
    skipped = 0
    for epoch, path in reversed(list_snapshots(state_dir)):
        try:
            return epoch, path, load_snapshot(path), skipped
        except (WalError, OSError):
            skipped += 1
    raise NoValidSnapshotError(f"no valid snapshot under {state_dir}")


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------

def write_manifest(state_dir: str, manifest: dict) -> None:
    """Atomically write the service manifest (idempotent config JSON)."""
    manifest = dict(manifest)
    manifest["format"] = MANIFEST_VERSION
    path = os.path.join(state_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def read_manifest(state_dir: str) -> dict:
    """Read the service manifest; raises ``WalError`` when missing or from a
    newer format version."""
    path = os.path.join(state_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        raise WalError(f"{state_dir}: no {MANIFEST_NAME} — not a state dir?")
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format", 0) > MANIFEST_VERSION:
        raise WalError(
            f"{path}: manifest format {manifest.get('format')} is newer "
            f"than this reader ({MANIFEST_VERSION})")
    return manifest


__all__ = [
    "CommitLog", "CommitRecord", "DurabilityOptions", "NoValidSnapshotError",
    "RecoveryInfo", "ReplayDivergenceError", "RestoreInfo", "RetractRecord",
    "WalError", "LOG_NAME", "MANIFEST_NAME", "MANIFEST_VERSION",
    "SNAPSHOT_VERSION", "SPILL_MAGIC", "WAL_VERSION",
    "latest_valid_snapshot", "list_snapshots", "load_framed",
    "load_snapshot", "read_manifest", "snapshot_path", "write_framed",
    "write_manifest", "write_snapshot",
]
