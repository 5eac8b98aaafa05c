"""The framed-file container of the durability layer, as far as the shard
plane's spill needs it.

A framed file is one header — magic, version, payload length, CRC32 —
followed by an npz payload of named arrays. ``write_framed`` writes through
a temp file and ``os.replace``, so a crash mid-write never leaves a
half-written file under the canonical name; ``load_framed`` refuses a torn
or bit-rotten frame with a ``WalError``. The byte layout is the JAX
package's (``repro.core.wal``), so a spill frame written by either package
loads in the other. The commit log, the snapshots and the manifest are not
carried yet (ROADMAP A.4).
"""
from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

#: Snapshot container version — versions the frame (header + npz payload).
SNAPSHOT_VERSION = 1

_SNAP_MAGIC = b"CDSN"           # snapshot file magic
SPILL_MAGIC = b"CDSP"           # spilled-chunk file magic (core/shardplan.py)
#: Frame header: magic, version u16, reserved u16, payload bytes u64,
#: CRC32 of the payload u32 — 20 bytes, little-endian.
_SNAP_HEADER = struct.Struct("<4sHHQI")


class WalError(RuntimeError):
    """Base class for durability-layer failures (an invalid frame here)."""


def _encode_arrays(arrays: dict) -> bytes:
    """Serialize a ``{name: ndarray}`` dict to npz bytes."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _decode_arrays(payload: bytes) -> dict:
    """Inverse of ``_encode_arrays`` (materialized — no open file handles)."""
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def write_framed(path: str, arrays: dict, magic: bytes = _SNAP_MAGIC,
                 version: int = SNAPSHOT_VERSION, fsync: bool = True) -> str:
    """Atomically write a checksummed framed npz container at ``path``;
    returns ``path``."""
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


__all__ = ["SNAPSHOT_VERSION", "SPILL_MAGIC", "WalError", "load_framed",
           "write_framed"]
