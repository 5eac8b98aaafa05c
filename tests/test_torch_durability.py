"""Durability of the port's detection service: commit log, snapshots,
kill/restart restore, rollback, retraction, and state dirs shared with the
JAX package.

The kill/restart contract: a durable ``DetectionService`` dropped at any
point — between commits, mid-log-write (torn tail), mid-snapshot-write —
restores to a service whose decisions, epochs and committed state equal a
twin that never died. The transient commit around each batch is unwound
bit for bit, index and mask cache, even when the pass raises mid-batch. A
state dir written by the JAX service (mode ``exact``, which runs on the
installed jax) restores in the port and one written by the port restores in
the JAX service, deciding alike; a JAX manifest of a multi-card engine is
refused with ``MeshNotPortedError``, and no manifest carries the device.
The ``gpu`` case restores a state dir written on the card on the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core.serving as jserving
from repro.core.types import ClaimsDataset as JClaimsDataset
from repro.core.types import CopyConfig as JCopyConfig
from repro_torch.core import (
    CopyConfig,
    DetectionService,
    DurabilityOptions,
    MeshNotPortedError,
    build_index,
    index_detect_exact,
)
from repro_torch.core.engine import EngineOptions
from repro_torch.core.serving import DetectRequest
from repro_torch.core.types import ClaimsDataset
from repro_torch.core.wal import LOG_NAME, MANIFEST_NAME, CommitLog, list_snapshots

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
JCFG = JCopyConfig(alpha=0.1, s=0.8, n=50.0)


def _world(seed=0, n_src=40, n_items=160):
    rng = np.random.default_rng(seed)
    values = np.where(rng.random((n_src, n_items)) < 0.45,
                      rng.integers(0, 4, (n_src, n_items)), -1).astype(np.int32)
    ds = ClaimsDataset(values=values,
                       accuracy=rng.uniform(0.3, 0.95, n_src).astype(np.float32))
    p = np.where(values == 0, 0.9,
                 np.where(values >= 0, 0.05, 0.0)).astype(np.float32)
    return ds, p


def _rows(seed, q, n_items=160):
    rng = np.random.default_rng(seed)
    vals = np.where(rng.random((q, n_items)) < 0.3,
                    rng.integers(0, 4, (q, n_items)), -1).astype(np.int32)
    acc = rng.uniform(0.3, 0.95, q).astype(np.float32)
    pq = np.where(vals == 0, 0.9,
                  np.where(vals >= 0, 0.05, 0.0)).astype(np.float32)
    return vals, acc, pq


def _request(seed, q=3, rid=0, cls=DetectRequest):
    vals, acc, pq = _rows(seed, q)
    return cls(rid=rid, values=vals, accuracy=acc, p_claim=pq)


def _svc(ds, p, tmp_path=None, mode="bucketed", **kw):
    dur = None
    if tmp_path is not None:
        dur = DurabilityOptions(state_dir=str(tmp_path),
                                **kw.pop("dur_kw", {}))
    return DetectionService(ds, p, CFG, mode=mode, tile=64, device="cpu",
                            durability=dur, **kw)


def _serve(svc, req):
    fut = svc.submit(req)
    svc.flush()
    return fut.result()


def _dense(svc):
    return svc._index.store.to_dense()


# ---------------------------------------------------------------------------
# kill/restart: restored service == never-restarted twin
# ---------------------------------------------------------------------------

SCHEDULE = [("commit", 1), ("serve", 21), ("commit", 2), ("serve", 22),
            ("serve", 21), ("commit", 3), ("serve", 23)]


def test_restore_equals_never_restarted(tmp_path):
    ds, p = _world(0)
    durable = _svc(ds, p, tmp_path, dur_kw={"snapshot_every": 2})
    twin = _svc(ds, p)
    for kind, seed in SCHEDULE:
        if kind == "commit":
            durable.commit(*_rows(seed, 3))
            twin.commit(*_rows(seed, 3))
        else:
            a, b = _serve(durable, _request(seed)), _serve(twin, _request(seed))
            np.testing.assert_array_equal(a.copying, b.copying)
    del durable                                  # "kill": no clean stop
    restored = DetectionService.restore(str(tmp_path), device="cpu")
    assert restored.epoch == twin.epoch == 3
    assert restored.stats.commits == twin.stats.commits
    assert restored.stats.committed_rows == twin.stats.committed_rows
    assert restored.resident.n_corpus == twin.resident.n_corpus
    np.testing.assert_array_equal(_dense(restored), _dense(twin))
    for seed in (21, 22, 23, 31):
        a = _serve(restored, _request(seed))
        b = _serve(twin, _request(seed))
        np.testing.assert_array_equal(a.copying, b.copying)
        np.testing.assert_array_equal(a.pr_independent, b.pr_independent)
        np.testing.assert_array_equal(a.intra_copying, b.intra_copying)
    restored.commit(*_rows(4, 2))
    twin.commit(*_rows(4, 2))
    assert restored.epoch == twin.epoch
    a, b = _serve(restored, _request(40)), _serve(twin, _request(40))
    np.testing.assert_array_equal(a.copying, b.copying)


def _rows_in_items(seed, q, lo, hi):
    """Rows whose claims live only on items [lo, hi): disjoint item ranges
    have disjoint claim keys, so their commits can't invalidate each
    other's cache entries."""
    vals, acc, pq = _rows(seed, q)
    vals, pq = vals.copy(), pq.copy()
    vals[:, :lo] = -1
    vals[:, hi:] = -1
    pq[vals < 0] = 0.0
    return vals, acc, pq


def test_restore_serves_warm_cache(tmp_path):
    """A request served before the snapshot is a cache HIT after restore
    when no replayed commit touches its claims."""
    ds, p = _world(5)
    svc = _svc(ds, p, tmp_path, dur_kw={"snapshot_every": 1})
    cold = _rows_in_items(50, 3, 0, 80)
    hot = _rows_in_items(51, 2, 120, 160)
    first = _serve(svc, DetectRequest(rid=0, values=cold[0],
                                      accuracy=cold[1], p_claim=cold[2]))
    assert not first.cache_hit
    _serve(svc, DetectRequest(rid=1, values=hot[0], accuracy=hot[1],
                              p_claim=hot[2]))
    svc.commit(*_rows_in_items(6, 2, 120, 160))
    del svc
    restored = DetectionService.restore(str(tmp_path), device="cpu")
    again = _serve(restored, DetectRequest(rid=2, values=cold[0],
                                           accuracy=cold[1], p_claim=cold[2]))
    assert again.cache_hit
    s0 = first.copying.shape[1]
    np.testing.assert_array_equal(first.copying, again.copying[:, :s0])
    assert not again.copying[:, s0:].any()
    miss = _serve(restored, DetectRequest(rid=3, values=hot[0],
                                          accuracy=hot[1], p_claim=hot[2]))
    assert not miss.cache_hit


def test_restore_replays_log_tail(tmp_path):
    ds, p = _world(2)
    durable = _svc(ds, p, tmp_path, dur_kw={"snapshot_every": 0})
    twin = _svc(ds, p)
    for seed in (1, 2, 3):
        durable.commit(*_rows(seed, 3))
        twin.commit(*_rows(seed, 3))
    del durable
    restored = DetectionService.restore(str(tmp_path), device="cpu")
    assert restored.restore_info.snapshot_epoch == 0
    assert restored.restore_info.replayed_commits == 3
    assert restored.epoch == twin.epoch == 3
    np.testing.assert_array_equal(_dense(restored), _dense(twin))
    a, b = _serve(restored, _request(60)), _serve(twin, _request(60))
    np.testing.assert_array_equal(a.copying, b.copying)


def test_restore_discards_torn_tail(tmp_path):
    """A SIGKILL mid-log-write loses exactly the torn commit."""
    ds, p = _world(7)
    durable = _svc(ds, p, tmp_path, dur_kw={"snapshot_every": 0})
    twin = _svc(ds, p)
    durable.commit(*_rows(1, 3))
    twin.commit(*_rows(1, 3))
    durable.commit(*_rows(2, 3))             # this record gets torn
    log = str(tmp_path / LOG_NAME)
    with open(log, "rb+") as f:
        f.truncate(os.path.getsize(log) - 9)
    restored = DetectionService.restore(str(tmp_path), device="cpu")
    assert restored.restore_info.discarded_bytes > 0
    assert restored.epoch == twin.epoch == 1
    np.testing.assert_array_equal(_dense(restored), _dense(twin))
    a, b = _serve(restored, _request(61)), _serve(twin, _request(61))
    np.testing.assert_array_equal(a.copying, b.copying)


def test_restore_skips_corrupt_newest_snapshot(tmp_path):
    ds, p = _world(4)
    durable = _svc(ds, p, tmp_path,
                   dur_kw={"snapshot_every": 1, "retention": 4})
    twin = _svc(ds, p)
    for seed in (1, 2, 3):
        durable.commit(*_rows(seed, 3))
        twin.commit(*_rows(seed, 3))
    del durable
    snaps = list_snapshots(str(tmp_path))
    assert [e for e, _ in snaps] == [0, 1, 2, 3]
    with open(snaps[-1][1], "rb+") as f:
        f.seek(30)
        f.write(b"\xde\xad\xbe\xef")
    restored = DetectionService.restore(str(tmp_path), device="cpu")
    assert restored.restore_info.skipped_snapshots == 1
    assert restored.restore_info.snapshot_epoch == 2
    assert restored.restore_info.replayed_commits == 1
    assert restored.epoch == twin.epoch == 3
    np.testing.assert_array_equal(_dense(restored), _dense(twin))


def test_restore_nonindexed_mode(tmp_path):
    """Durability works for modes without a committed index."""
    ds, p = _world(6)
    kw = dict(sample_rate=0.3, sample_seed=1)
    svc = _svc(ds, p, tmp_path, mode="sample_verify",
               dur_kw={"snapshot_every": 2}, **kw)
    twin = _svc(ds, p, mode="sample_verify", **kw)
    for seed in (1, 2, 3):
        svc.commit(*_rows(seed, 3))
        twin.commit(*_rows(seed, 3))
    del svc
    restored = DetectionService.restore(str(tmp_path), device="cpu")
    assert restored.epoch == twin.epoch == 3
    assert restored._index is None
    a, b = _serve(restored, _request(70)), _serve(twin, _request(70))
    np.testing.assert_array_equal(a.copying, b.copying)


# ---------------------------------------------------------------------------
# rollbacks: the last commit, and the transient commit around a batch
# ---------------------------------------------------------------------------

def test_rollback_last_commit_bit_exact(tmp_path):
    ds, p = _world(8)
    svc = _svc(ds, p, tmp_path, dur_kw={"snapshot_every": 0})
    ref = _svc(ds, p)
    svc.commit(*_rows(1, 3))
    ref.commit(*_rows(1, 3))
    log = str(tmp_path / LOG_NAME)
    size1 = os.path.getsize(log)
    _serve(svc, _request(80))                 # memoized at epoch 1
    svc.commit(*_rows(2, 4))
    svc.rollback_last_commit()
    assert svc.epoch == ref.epoch == 1
    assert svc.resident.n_corpus == ref.resident.n_corpus
    assert svc.stats.commits == ref.stats.commits == 1
    np.testing.assert_array_equal(_dense(svc), _dense(ref))
    np.testing.assert_array_equal(svc._index.l_counts, ref._index.l_counts)
    assert os.path.getsize(log) == size1      # the record is gone too
    with pytest.raises(RuntimeError):
        svc.rollback_last_commit()            # LIFO: only once
    a, b = _serve(svc, _request(81)), _serve(ref, _request(81))
    np.testing.assert_array_equal(a.copying, b.copying)
    assert DetectionService.restore(str(tmp_path), device="cpu").epoch == 1


class InjectedFault(RuntimeError):
    """A fault planted in the middle of an engine pass."""


def _index_state(svc):
    return {k: np.array(v, copy=True)
            for k, v in svc._index.state_dict().items()}


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("warm", [True, False])
def test_transient_commit_rolls_back_when_the_pass_raises(warm, monkeypatch):
    """A pass that raises after the batch's transient commit (mid-scan)
    leaves the committed index bit-exact and the engine's mask cache at its
    pre-batch bits (``warm``: a cache existed; otherwise the adopted one is
    rebased or dropped); the next batch decides like the exact INDEX."""
    ds, p = _world(9)
    svc = _svc(ds, p, result_cache=False)
    req = _request(90)
    if warm:
        _serve(svc, _request(91))             # builds the mask cache
        cache_bits = svc.engine._mask_cache.block_inc.copy()
    before = _index_state(svc)
    orig = svc.engine._run_tiled_scan
    calls = {"n": 0}

    def failing_scan(ctx):
        calls["n"] += 1
        assert svc._index.store.n_rows > ds.n_sources   # mid-transient
        raise InjectedFault("scan died mid-pass")

    monkeypatch.setattr(svc.engine, "_run_tiled_scan", failing_scan)
    fut = svc.submit(req)
    svc.flush()
    with pytest.raises(InjectedFault):
        fut.result()
    assert calls["n"] == 1
    assert svc.stats.failed_batches == 1 and svc.stats.failed_requests == 1
    _assert_state_equal(before, _index_state(svc))
    if warm:
        np.testing.assert_array_equal(svc.engine._mask_cache.block_inc,
                                      cache_bits)
    monkeypatch.setattr(svc.engine, "_run_tiled_scan", orig)
    got = _serve(svc, req)
    union = ClaimsDataset(values=np.concatenate([ds.values, req.values]),
                          accuracy=np.concatenate([ds.accuracy, req.accuracy]))
    up = np.concatenate([p, req.p_claim])
    exact = index_detect_exact(union, up, CFG,
                               index=build_index(union, up, CFG, device="cpu"))
    S0 = ds.n_sources
    np.testing.assert_array_equal(got.copying, exact.copying[S0:, :S0])
    np.testing.assert_array_equal(got.intra_copying, exact.copying[S0:, S0:])
    if warm:
        assert svc.engine.last_stats["mask_source"] == "cache"


# ---------------------------------------------------------------------------
# retraction
# ---------------------------------------------------------------------------

def _answers(svc, seeds, tag):
    futs = [svc.submit(_request(s, rid=f"{tag}-{s}")) for s in seeds]
    svc.flush()
    return [f.result(timeout=30) for f in futs]


def test_retract_with_warm_cache_equals_rebuild():
    ds, p = _world(11)
    seeds = (101, 102, 103)
    svc = _svc(ds, p)
    _answers(svc, seeds, "warm")
    _answers(svc, seeds, "warm")
    assert svc.cache.hits > 0
    row_ids = [3, 17, 31]
    info = svc.retract(row_ids)
    assert info.rows == 3
    assert svc.stats.retractions == 1 and svc.stats.retracted_rows == 3
    after = _answers(svc, seeds, "after")
    keep = np.setdiff1d(np.arange(ds.n_sources), row_ids)
    ref = _svc(ClaimsDataset(values=ds.values[keep],
                             accuracy=ds.accuracy[keep]), p[keep],
               result_cache=False)
    for a, b in zip(after, _answers(ref, seeds, "ref")):
        np.testing.assert_array_equal(a.copying, b.copying)
        np.testing.assert_array_equal(a.intra_copying, b.intra_copying)
        assert a.copying.shape[1] == keep.size


def test_retract_rollback_bit_exact_and_lifo():
    ds, p = _world(12)
    seeds = (111, 112)
    svc = _svc(ds, p)
    before = _answers(svc, seeds, "before")
    state = _index_state(svc)
    e0, n0 = svc.epoch, svc.resident.n_corpus
    svc.retract([0, 7])
    assert svc.epoch == e0 + 1 and svc.resident.n_corpus == n0 - 2
    svc.rollback_last_retract()
    assert svc.epoch == e0 and svc.resident.n_corpus == n0
    assert svc.stats.retractions == 0 and svc.stats.retracted_rows == 0
    _assert_state_equal(state, _index_state(svc))
    for a, b in zip(_answers(svc, seeds, "rb"), before):
        np.testing.assert_array_equal(a.copying, b.copying)
    with pytest.raises(RuntimeError, match="no retraction"):
        svc.rollback_last_retract()
    with pytest.raises(ValueError, match="no rows"):
        svc.retract([])
    with pytest.raises(ValueError, match="row ids"):
        svc.retract([ds.n_sources])
    svc.retract([5])
    svc.commit(*_rows(13, 1))
    with pytest.raises(RuntimeError, match="no retraction"):
        svc.rollback_last_retract()
    svc.retract([9])
    with pytest.raises(RuntimeError, match="no commit"):
        svc.rollback_last_commit()


def test_restore_replays_retraction_from_wal(tmp_path):
    ds, p = _world(13)
    svc = _svc(ds, p, tmp_path, dur_kw={"snapshot_every": 0})
    svc.commit(*_rows(1, 2))
    svc.retract([2, ds.n_sources])            # a base row, a committed row
    svc.commit(*_rows(2, 2))
    live = _answers(svc, (121, 122), "live")
    e_live, n_live = svc.epoch, svc.resident.n_corpus
    del svc
    records, _, _ = CommitLog.scan(str(tmp_path / LOG_NAME))
    assert [type(r).__name__ for r in records] == [
        "CommitRecord", "RetractRecord", "CommitRecord"]
    svc2 = DetectionService.restore(str(tmp_path), device="cpu")
    assert svc2.restore_info.replayed_commits == 3
    assert svc2.epoch == e_live and svc2.resident.n_corpus == n_live
    assert svc2.stats.retractions == 1 and svc2.stats.retracted_rows == 2
    for a, b in zip(_answers(svc2, (121, 122), "restored"), live):
        np.testing.assert_array_equal(a.copying, b.copying)
        np.testing.assert_array_equal(a.intra_copying, b.intra_copying)


# ---------------------------------------------------------------------------
# state dirs across packages (mode exact: the JAX service runs there)
# ---------------------------------------------------------------------------

def _jax_svc(ds, p, tmp_path=None, **kw):
    dur = None
    if tmp_path is not None:
        dur = jserving.DurabilityOptions(state_dir=str(tmp_path),
                                         snapshot_every=kw.pop("every", 2))
    return jserving.DetectionService(
        JClaimsDataset(values=ds.values, accuracy=ds.accuracy), p, JCFG,
        mode="exact", tile=64, durability=dur, **kw)


def _schedule(svc, req_cls):
    """Commits, a retraction, a request memoized before the snapshot (every
    4 mutations) and one after it, and a commit in the log tail."""
    svc.commit(*_rows(1, 3))
    svc.commit(*_rows(2, 2))
    svc.retract([4, 41])
    _serve(svc, _request(130, cls=req_cls))
    svc.commit(*_rows(3, 2))                  # epoch 4: the snapshot
    _serve(svc, _request(131, cls=req_cls))
    svc.commit(*_rows(4, 2))                  # epoch 5: the log tail


def _cross_check(port, jax, seeds):
    """The same requests on both sides: decisions equal, scores within the
    float32 bar, and — when both came from one state dir — cache hits
    equal."""
    for s in seeds:
        a = _serve(port, _request(s))
        b = _serve(jax, _request(s, cls=jserving.DetectRequest))
        np.testing.assert_array_equal(a.copying, b.copying)
        np.testing.assert_array_equal(a.intra_copying, b.intra_copying)
        np.testing.assert_allclose(a.c_fwd, b.c_fwd, rtol=2e-5, atol=1e-4)
        assert a.cache_hit == b.cache_hit


def test_jax_state_dir_restores_in_port(tmp_path):
    """A state dir written by the JAX service (commits, a retraction, a
    warm cache, a log tail past the last snapshot) restores in the port:
    same epoch, corpus, index and stats as the JAX service it came from,
    which it decides like; and like the JAX service restored from the same
    dir, warm cache hits included."""
    ds, p = _world(14)
    j = _jax_svc(ds, p, tmp_path, every=4)
    _schedule(j, jserving.DetectRequest)
    t = DetectionService.restore(str(tmp_path), device="cpu")
    assert t.engine.mode == "exact"
    assert t.epoch == j.epoch == 5
    assert t.restore_info.snapshot_epoch == 4
    assert t.restore_info.replayed_commits == 1
    assert t.resident.n_corpus == j.resident.n_corpus
    np.testing.assert_array_equal(
        t.resident.values[:t.resident.n_corpus],
        j.resident.values[:j.resident.n_corpus])
    np.testing.assert_array_equal(_dense(t), j._index.store.to_dense())
    assert [getattr(t.stats, f) for f in ("commits", "retractions",
                                          "committed_rows")] == [
        getattr(j.stats, f) for f in ("commits", "retractions",
                                      "committed_rows")]
    j2 = jserving.DetectionService.restore(str(tmp_path))
    assert len(t.cache._entries) == len(j2.cache._entries) > 0
    _cross_check(t, j2, (130, 131, 132, 130))
    _cross_check(t, j, (133,))


def test_port_state_dir_restores_in_jax(tmp_path):
    ds, p = _world(15)
    t = _svc(ds, p, tmp_path, mode="exact", dur_kw={"snapshot_every": 4})
    _schedule(t, DetectRequest)
    manifest = json.loads((tmp_path / MANIFEST_NAME).read_text())
    assert set(manifest["engine_options"]) == {
        f.name for f in EngineOptions.__dataclass_fields__.values()}
    assert "device" not in json.dumps(manifest)
    j = jserving.DetectionService.restore(str(tmp_path))
    assert j.epoch == t.epoch == 5
    assert j.restore_info.replayed_commits == 1
    np.testing.assert_array_equal(j._index.store.to_dense(), _dense(t))
    t2 = DetectionService.restore(str(tmp_path), device="cpu")
    assert len(t2.cache._entries) == len(j.cache._entries) > 0
    _cross_check(t2, j, (130, 131, 132, 130))
    _cross_check(t, j, (133,))


@pytest.mark.parametrize("patch,ok", [
    ({"mesh_shape": [2, 2]}, False),
    ({"devices": 4}, False),
    ({"devices": 1, "kernel_impl": "ref"}, True),
])
def test_jax_manifest_engine_options(tmp_path, patch, ok):
    """A JAX manifest's ``devices`` / ``kernel_impl`` / ``mesh_shape``: a
    multi-card engine is refused, typed, naming A.3b; one card restores."""
    ds, p = _world(16)
    j = _jax_svc(ds, p, tmp_path)
    j.commit(*_rows(1, 2))
    path = tmp_path / MANIFEST_NAME
    manifest = json.loads(path.read_text())
    assert {"devices", "kernel_impl", "mesh_shape"} <= set(
        manifest["engine_options"])
    manifest["engine_options"].update(patch)
    path.write_text(json.dumps(manifest))
    if not ok:
        with pytest.raises(MeshNotPortedError, match="A.3b"):
            DetectionService.restore(str(tmp_path), device="cpu")
        return
    t = DetectionService.restore(str(tmp_path), device="cpu")
    assert t.epoch == 1
    _cross_check(t, j, (150,))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_state_dir_restores_on_cpu(cuda_device, tmp_path):
    """A state dir written by a bucketed service on the card restores on
    the CPU (no device in the manifest) and decides alike; and back."""
    ds, p = _world(17)
    card = DetectionService(ds, p, CFG, mode="bucketed", tile=64,
                            device=cuda_device,
                            durability=DurabilityOptions(str(tmp_path),
                                                         snapshot_every=2))
    _serve(card, _request(160))
    for seed in (1, 2, 3):
        card.commit(*_rows(seed, 3))
    cpu = DetectionService.restore(str(tmp_path), device="cpu")
    assert cpu.engine.device.type == "cpu" and cpu.epoch == 3
    for s in (160, 161):
        a, b = _serve(card, _request(s)), _serve(cpu, _request(s))
        np.testing.assert_array_equal(a.copying, b.copying)
        np.testing.assert_allclose(a.c_fwd, b.c_fwd, rtol=2e-5, atol=1e-4)
    back = DetectionService.restore(str(tmp_path), device=cuda_device)
    assert back.engine.device.type == "cuda"
    a, b = _serve(back, _request(162)), _serve(cpu, _request(162))
    np.testing.assert_array_equal(a.copying, b.copying)
