"""The port's durability layer (``repro_torch.core.wal``) against the JAX
package's (``repro.core.wal``).

The commit log, the snapshots and the manifest have one byte layout in both
packages, so every case writes with one package and reads with the other
(and with itself): records round-trip field for field, a torn tail under
each kind of damage is truncated back to the last valid record by either
reader, the last append unwinds LIFO, snapshot retention prunes and a
corrupt newest snapshot falls back to the previous one, and a manifest read
by the other package returns the same config.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import os

import numpy as np
import pytest

import repro.core.wal as jwal
import repro_torch.core.wal as twal
from repro_torch.core.types import claim_value_keys

PACKAGES = {"jax": jwal, "port": twal}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


def _rows(seed, q, n_items=160):
    rng = np.random.default_rng(seed)
    vals = np.where(rng.random((q, n_items)) < 0.3,
                    rng.integers(0, 4, (q, n_items)), -1).astype(np.int32)
    acc = rng.uniform(0.3, 0.95, q).astype(np.float32)
    pq = np.where(vals == 0, 0.9,
                  np.where(vals >= 0, 0.05, 0.0)).astype(np.float32)
    return vals, acc, pq


def _record(wal, seed, epoch, q=3, owner=(-1, -1)):
    vals, acc, pq = _rows(seed, q)
    return wal.CommitRecord(epoch=epoch, values=vals, accuracy=acc,
                            p_claim=pq, touched_keys=claim_value_keys(vals),
                            compact=bool(epoch % 2), compacted=False,
                            owner_lo=owner[0], owner_hi=owner[1])


def test_constants_and_defaults_equal_jax():
    for name in ("WAL_VERSION", "SNAPSHOT_VERSION", "MANIFEST_VERSION",
                 "REC_COMMIT", "REC_RETRACT", "LOG_NAME", "MANIFEST_NAME",
                 "SPILL_MAGIC"):
        assert getattr(twal, name) == getattr(jwal, name), name
    t, j = twal.DurabilityOptions("d"), jwal.DurabilityOptions("d")
    assert (t.snapshot_every, t.fsync, t.retention) == (16, "commit", 2)
    assert (t.snapshot_every, t.fsync, t.retention) == (
        j.snapshot_every, j.fsync, j.retention)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_log_roundtrip_across_packages(tmp_path, writer, reader):
    """Commit and retraction records, owner ranges included, read back field
    for field by either package."""
    w, r = PACKAGES[writer], PACKAGES[reader]
    path = str(tmp_path / "commits.wal")
    log = w.CommitLog(path)
    recs = [_record(w, 1, 1), _record(w, 2, 2, owner=(40, 43)),
            w.RetractRecord(epoch=3, row_ids=np.array([2, 5], np.int64),
                            touched_keys=np.array([7, 9], np.int64),
                            n_before=46, owner_lo=2, owner_hi=6),
            _record(w, 3, 4)]
    for rec in recs:
        log.append(rec)
    log.close()
    back = list(r.CommitLog.read(path))
    assert [type(b).__name__ for b in back] == [
        "CommitRecord", "CommitRecord", "RetractRecord", "CommitRecord"]
    for a, b in zip(recs, back):
        assert (a.epoch, a.owner_lo, a.owner_hi) == (
            b.epoch, b.owner_lo, b.owner_hi)
        np.testing.assert_array_equal(a.touched_keys, b.touched_keys)
        if type(a).__name__ == "CommitRecord":
            np.testing.assert_array_equal(a.values, b.values)
            np.testing.assert_array_equal(a.accuracy, b.accuracy)
            np.testing.assert_array_equal(a.p_claim, b.p_claim)
            assert (a.compact, a.compacted) == (b.compact, b.compacted)
        else:
            np.testing.assert_array_equal(a.row_ids, b.row_ids)
            assert a.n_before == b.n_before


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("damage", ["truncate_header", "truncate_payload",
                                    "garbage", "crc_flip"])
def test_log_torn_tail_recovery(tmp_path, writer, damage):
    """Any mid-write drop of the LAST record truncates back to the valid
    prefix under the port's recovery, on a log either package wrote; the
    earlier records survive untouched and the JAX reader agrees."""
    w = PACKAGES[writer]
    path = str(tmp_path / "commits.wal")
    log = w.CommitLog(path)
    for s, e in ((1, 1), (2, 2)):
        log.append(_record(w, s, e))
    clean = os.path.getsize(path)
    log.append(_record(w, 3, 3))
    log.close()
    full = os.path.getsize(path)
    with open(path, "rb+") as f:
        if damage == "truncate_header":
            f.truncate(clean + 7)            # mid third-record header
        elif damage == "truncate_payload":
            f.truncate(full - 5)             # payload cut short
        elif damage == "garbage":
            f.truncate(clean)
            f.seek(clean)
            f.write(b"\x00garbage that is not a record header")
        elif damage == "crc_flip":
            f.seek(clean + 20)               # inside the third payload
            byte = f.read(1)
            f.seek(clean + 20)
            f.write(bytes([byte[0] ^ 0xFF]))
    assert jwal.CommitLog.scan(path)[1:] == twal.CommitLog.scan(path)[1:]
    info = twal.CommitLog.recover(path)
    assert info.records == 2
    assert info.discarded_bytes > 0
    assert os.path.getsize(path) == clean
    assert [r.epoch for r in twal.CommitLog.read(path)] == [1, 2]
    assert [r.epoch for r in jwal.CommitLog.read(path)] == [1, 2]
    again = twal.CommitLog.recover(path)
    assert again.discarded_bytes == 0 and again.records == 2


def test_log_rollback_last(tmp_path):
    path = str(tmp_path / "commits.wal")
    log = twal.CommitLog(path)
    log.append(_record(twal, 1, 1))
    size1 = os.path.getsize(path)
    log.append(_record(twal, 2, 2))
    log.rollback_last()
    assert os.path.getsize(path) == size1
    assert [r.epoch for r in twal.CommitLog.read(path)] == [1]
    with pytest.raises(twal.WalError):
        log.rollback_last()                  # only the LAST append unwinds
    log.append(_record(twal, 3, 2))          # appending again still works
    assert [r.epoch for r in jwal.CommitLog.read(path)] == [1, 2]
    log.close()
    with pytest.raises(ValueError, match="fsync"):
        twal.CommitLog(path, fsync="sometimes")


def test_wal_owner_range_back_compat():
    """A record without the owner range (3-int / 2-int meta) decodes as
    unscoped; a scoped record keeps its range."""
    old_commit = twal._encode_arrays({
        "values": np.zeros((1, 4), np.int32),
        "accuracy": np.zeros(1, np.float32),
        "p_claim": np.zeros((1, 4), np.float32),
        "touched_keys": np.zeros(0, np.int64),
        "meta": np.array([3, 1, 0], np.int64)})
    rec = twal.CommitRecord.from_payload(old_commit)
    assert (rec.owner_lo, rec.owner_hi) == (-1, -1)
    assert (rec.epoch, rec.compact, rec.compacted) == (3, True, False)
    old_retract = twal._encode_arrays({
        "row_ids": np.array([2], np.int64),
        "touched_keys": np.zeros(0, np.int64),
        "meta": np.array([4, 10], np.int64)})
    rrec = twal.RetractRecord.from_payload(old_retract)
    assert (rrec.owner_lo, rrec.owner_hi) == (-1, -1)
    assert (rrec.epoch, rrec.n_before) == (4, 10)
    rt = jwal.CommitRecord.from_payload(
        _record(twal, 4, 5, q=1, owner=(64, 68)).payload())
    assert (rt.owner_lo, rt.owner_hi) == (64, 68)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_snapshot_roundtrip_and_retention(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    sd = str(tmp_path)
    arrays = {"a": np.arange(12, dtype=np.int64).reshape(3, 4),
              "b": np.float32([1.5, -2.0])}
    for epoch in (1, 2, 3):
        path = w.write_snapshot(sd, epoch, arrays, retention=2)
    assert path == r.snapshot_path(sd, 3)
    assert [e for e, _ in r.list_snapshots(sd)] == [2, 3]   # pruned
    epoch, path, back, skipped = r.latest_valid_snapshot(sd)
    assert epoch == 3 and skipped == 0
    np.testing.assert_array_equal(back["a"], arrays["a"])
    np.testing.assert_array_equal(back["b"], arrays["b"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_corruption_falls_back(tmp_path, writer):
    w = PACKAGES[writer]
    sd = str(tmp_path)
    w.write_snapshot(sd, 1, {"a": np.arange(4)})
    p2 = w.write_snapshot(sd, 2, {"a": np.arange(8)})
    with open(p2, "rb+") as f:
        f.truncate(os.path.getsize(p2) - 3)  # torn mid-snapshot-write
    with pytest.raises(twal.WalError):
        twal.load_snapshot(p2)
    epoch, _, back, skipped = twal.latest_valid_snapshot(sd)
    assert epoch == 1 and skipped == 1
    assert len(back["a"]) == 4
    os.remove(p2)
    os.remove(twal.list_snapshots(sd)[0][1])
    with pytest.raises(twal.NoValidSnapshotError):
        twal.latest_valid_snapshot(sd)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_manifest_across_packages(tmp_path, writer, reader):
    """A manifest written by one package reads back equal in the other; a
    newer format or a missing file is refused."""
    w, r = PACKAGES[writer], PACKAGES[reader]
    manifest = {"cfg": {"alpha": 0.1, "s": 0.8, "n": 50.0},
                "service": {"mode": "exact", "max_batch_requests": 8},
                "engine_options": {"tile": 64, "prefetch_depth": 2},
                "durability": {"snapshot_every": 16, "fsync": "commit",
                               "retention": 2}}
    w.write_manifest(str(tmp_path), manifest)
    back = r.read_manifest(str(tmp_path))
    assert back == {**manifest, "format": r.MANIFEST_VERSION}
    w.write_manifest(str(tmp_path), manifest)
    path = tmp_path / r.MANIFEST_NAME
    path.write_text(path.read_text().replace('"format": 1', '"format": 99'))
    with pytest.raises(twal.WalError, match="newer"):
        twal.read_manifest(str(tmp_path))
    with pytest.raises(twal.WalError, match="manifest"):
        twal.read_manifest(str(tmp_path / "absent"))
