"""The port's ``ReplicaRouter``: the commit broadcast with LIFO rollback,
per-replica state dirs, and the shard-owner fleet.

Replica fleets: a replica that fails mid-broadcast rolls the replicas that
already applied back, bit for bit, and the fleet stays at the pre-write
epoch; each replica of a durable fleet persists and restores from its own
``replica-<i>/`` dir. Shard-owner fleets (``shard_owners=N``): in every
tiled fan-out mode (``bucketed``, ``sampled``, ``sample_verify``) the
fleet decides like a single service, and ``bucketed`` like
``index_detect_exact``; a dead owner mid-scan is one typed
``ShardScanError`` with nothing merged, and its breaker gates the rejoin;
commits and retractions carry the owning row range into every replica's
log, and the replicas restore independently; ``rebalance`` re-splits a
skewed plan and decides like a fresh build. The breaker's eject/rejoin
cycle and the all-open refusal are in ``test_torch_overload.py``.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import os

import numpy as np
import pytest

from repro_torch.core import (
    CopyConfig,
    DetectionService,
    DurabilityOptions,
    ReplicaBroadcastError,
    ReplicaRouter,
    ShardedCorpusStore,
    ShardScanError,
    build_index,
    index_detect_exact,
    make_shard_plan,
)
from repro_torch.core.serving import DetectRequest
from repro_torch.core.types import ClaimsDataset
from repro_torch.core.wal import CommitLog

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
KW = dict(tile=16, device="cpu", sample_rate=0.5, sample_seed=1)


class InjectedFault(RuntimeError):
    """A fault planted in one replica or one owner."""


class FakeClock:
    """A deterministic, manually advanced monotonic clock."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now


def _corpus(S=64, D=32, V=5, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, V, (S, D)).astype(np.int32)
    vals[rng.random((S, D)) < 0.3] = -1
    vals[8] = vals[3]                       # one certain copier pair
    acc = rng.uniform(0.4, 0.9, S).astype(np.float32)
    p = rng.uniform(0.3, 0.9, (S, D)).astype(np.float32)
    return ClaimsDataset(values=vals, accuracy=acc), p


def _query(ds, q=4, seed=1):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 5, (q, ds.n_items)).astype(np.int32)
    vals[rng.random((q, ds.n_items)) < 0.3] = -1
    vals[0] = ds.values[3]
    acc = rng.uniform(0.4, 0.9, q).astype(np.float32)
    p = rng.uniform(0.3, 0.9, (q, ds.n_items)).astype(np.float32)
    return vals, acc, p


def _serve_one(svc, req):
    fut = svc.submit(req)
    svc.flush()
    return fut.result()


def _req(qv, qa, qp, rid=1):
    return DetectRequest(rid=rid, values=qv, accuracy=qa, p_claim=qp)


# ---------------------------------------------------------------------------
# replica fleets
# ---------------------------------------------------------------------------

def test_router_broadcast_failure_rolls_back():
    """One replica raising mid-broadcast must not leave the fleet
    split-brained: the replicas before it unwind LIFO, bit for bit."""
    ds, p = _corpus(seed=9)
    router = ReplicaRouter(ds, p, CFG, n_replicas=3, mode="bucketed", **KW)
    ref = DetectionService(ds, p, CFG, mode="bucketed", **KW)
    qv, qa, qp = _query(ds, q=6, seed=2)
    router.commit(qv[:2], qa[:2], qp[:2])
    ref.commit(qv[:2], qa[:2], qp[:2])
    calls = {"n": 0}
    orig = DetectionService.commit

    def failing(self, *a, **kw):
        calls["n"] += 1
        if self is router.replicas[2]:
            raise InjectedFault("replica 2 lost its disk")
        return orig(self, *a, **kw)

    for svc in router.replicas:
        svc.commit = failing.__get__(svc)
    with pytest.raises(ReplicaBroadcastError) as ei:
        router.commit(qv[2:5], qa[2:5], qp[2:5])
    assert ei.value.replica == 2
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert calls["n"] == 3                   # replicas 0, 1 applied first
    assert router.epoch == ref.epoch == 1
    for svc in router.replicas:
        assert svc.resident.n_corpus == ref.resident.n_corpus
        np.testing.assert_array_equal(svc._index.store.to_dense(),
                                      ref._index.store.to_dense())
        np.testing.assert_array_equal(svc._index.l_counts,
                                      ref._index.l_counts)
    for svc in router.replicas:
        svc.commit = orig.__get__(svc)
    router.commit(qv[5:], qa[5:], qp[5:])
    ref.commit(qv[5:], qa[5:], qp[5:])
    assert router.epoch == ref.epoch == 2
    req = _req(*_query(ds, seed=3))
    a, b = _serve_one(router.replicas[2], req), _serve_one(ref, req)
    np.testing.assert_array_equal(a.copying, b.copying)
    # reads round-robin over the in-sync replicas
    futs = [router.submit(req) for _ in range(3)]
    router.flush()
    for f in futs:
        np.testing.assert_array_equal(f.result().copying, b.copying)


def test_router_per_replica_state_dirs(tmp_path):
    ds, p = _corpus(seed=10)
    dur = DurabilityOptions(state_dir=str(tmp_path), snapshot_every=1)
    router = ReplicaRouter(ds, p, CFG, n_replicas=2, mode="bucketed",
                           durability=dur, **KW)
    qv, qa, qp = _query(ds, q=3)
    router.commit(qv, qa, qp)
    for i in range(2):
        sub = tmp_path / f"replica-{i}"
        assert (sub / "manifest.json").exists()
        assert (sub / "commits.wal").exists()
        restored = DetectionService.restore(str(sub), device="cpu")
        assert restored.epoch == 1
        np.testing.assert_array_equal(
            restored._index.store.to_dense(),
            router.replicas[i]._index.store.to_dense())


# ---------------------------------------------------------------------------
# shard-owner fleets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("owners", [2, 4])
@pytest.mark.parametrize("mode", ["bucketed", "sampled", "sample_verify"])
def test_owner_fleet_equals_single_service(mode, owners):
    """Through a commit and a retraction, the fleet's fan-out decides like
    one service over an unsharded index (bucketed: like the exact INDEX)."""
    ds, p = _corpus(S=96, seed=4)
    single = DetectionService(ds, p, CFG, mode=mode, **KW)
    router = ReplicaRouter(ds, p, CFG, shard_owners=owners, mode=mode,
                           shard_pack=True, **KW)
    qv, qa, qp = _query(ds, q=8, seed=5)
    req = _req(qv[:4], qa[:4], qp[:4])
    steps = [None, ("commit", (qv[4:6], qa[4:6], qp[4:6])),
             ("retract", ([1, 50],))]
    for step in steps:
        if step is not None:
            getattr(router, step[0])(*step[1])
            getattr(single, step[0])(*step[1])
        got, want = _serve_one(router, req), _serve_one(single, req)
        np.testing.assert_array_equal(got.copying, want.copying)
        np.testing.assert_array_equal(got.intra_copying, want.intra_copying)
        np.testing.assert_allclose(got.c_fwd, want.c_fwd, rtol=2e-5,
                                   atol=1e-4)
        if mode == "bucketed":
            svc = router.replicas[0]
            n = svc.resident.n_corpus
            union = ClaimsDataset(
                values=np.concatenate([svc.resident.values[:n], req.values]),
                accuracy=np.concatenate([svc.resident.accuracy[:n],
                                         req.accuracy]))
            up = np.concatenate([svc.resident.p_claim[:n], req.p_claim])
            exact = index_detect_exact(
                union, up, CFG, index=build_index(union, up, CFG,
                                                  device="cpu"))
            np.testing.assert_array_equal(got.copying,
                                          exact.copying[n:, :n])
    assert router.epoch == single.epoch == 2
    if mode == "bucketed":          # the sampled modes keep no index
        assert isinstance(router.replicas[0]._index.store,
                          ShardedCorpusStore)
        assert all(r._index is router.replicas[0]._index
                   for r in router.replicas)


def test_dead_owner_mid_scan_typed_error_then_rejoin():
    ds, p = _corpus()
    qv, qa, qp = _query(ds)
    req = _req(qv, qa, qp)
    single = DetectionService(ds, p, CFG, mode="bucketed", **KW)
    clock = FakeClock()
    router = ReplicaRouter(ds, p, CFG, shard_owners=2, mode="bucketed",
                           breaker_threshold=2, breaker_cooldown_s=5.0,
                           breaker_clock=clock, **KW)
    eng = router.replicas[0].engine
    orig_partial = eng.detect_owner_partial
    orig_finalize = eng.finalize_owner_partials
    calls = {"partial": 0, "finalize": 0}

    def dead_owner_1(ds_, p_, owner, index=None, ctx=None):
        calls["partial"] += 1
        if owner == 1:
            raise InjectedFault("owner host 1 is unreachable")
        return orig_partial(ds_, p_, owner, index=index, ctx=ctx)

    def counting_finalize(*a, **kw):
        calls["finalize"] += 1
        return orig_finalize(*a, **kw)

    before = router.replicas[0]._index.store.to_dense()
    eng.detect_owner_partial = dead_owner_1
    eng.finalize_owner_partials = counting_finalize
    try:
        with pytest.raises(ShardScanError) as ei:
            router.submit(req).result()
        assert ei.value.shard == 1
        assert calls["finalize"] == 0
        assert router.breakers[1].failures == 1
        # the transient commit unwound: the shared index is as before
        np.testing.assert_array_equal(
            router.replicas[0]._index.store.to_dense(), before)
        with pytest.raises(ShardScanError):
            router.submit(req).result()
        assert router.breakers[1].state == "open"
        seen = calls["partial"]
        with pytest.raises(ShardScanError, match="circuit-open") as ei:
            router.submit(req).result()
        assert ei.value.shard == 1
        assert calls["partial"] == seen + 1      # owner 0 probed, 1 skipped
        infos = router.commit(qv[:2], qa[:2], qp[:2])
        assert infos[1] is None and len(router._backlogs[1]) == 1
        assert router._in_sync() == [0]
    finally:
        eng.detect_owner_partial = orig_partial
        eng.finalize_owner_partials = orig_finalize
    clock.advance(6.0)
    replayed = router.catch_up()
    assert replayed[1] == 1 and not router._backlogs[1]
    assert router.breakers[1].state == "closed"
    assert router._in_sync() == [0, 1]
    assert router.epoch == 1
    single.commit(qv[:2], qa[:2], qp[:2])
    req2 = _req(qv, qa, qp, rid=2)
    got, want = _serve_one(router, req2), _serve_one(single, req2)
    np.testing.assert_array_equal(got.copying, want.copying)
    np.testing.assert_allclose(got.c_fwd, want.c_fwd, rtol=2e-5, atol=1e-4)
    assert router.stats.failed_batches == 3


def test_owner_range_in_wal_and_independent_restore(tmp_path):
    ds, p = _corpus()
    qv, qa, qp = _query(ds, q=6)
    state = str(tmp_path / "fleet")
    router = ReplicaRouter(
        ds, p, CFG, shard_owners=2, mode="bucketed",
        durability=DurabilityOptions(state_dir=state, snapshot_every=0), **KW)
    n0 = ds.n_sources
    router.commit(qv[:4], qa[:4], qp[:4])
    router.retract([1, 3])
    router.commit(qv[4:6], qa[4:6], qp[4:6])
    live_epoch = router.epoch
    live_dense = router.replicas[0]._index.store.to_dense()
    for i in range(2):
        records, _, _ = CommitLog.scan(
            os.path.join(state, f"replica-{i}", "commits.wal"))
        assert [type(r).__name__ for r in records] == [
            "CommitRecord", "RetractRecord", "CommitRecord"]
        assert (records[0].owner_lo, records[0].owner_hi) == (n0, n0 + 4)
        assert (records[1].owner_lo, records[1].owner_hi) == (1, 4)
        assert (records[2].owner_lo, records[2].owner_hi) == (n0 + 2, n0 + 4)
        plan = router._owner_plan()
        assert plan.owner_of_row(records[0].owner_lo) == plan.owner_of_row(
            records[0].owner_hi - 1)
    primary = DetectionService.restore(os.path.join(state, "replica-0"),
                                       device="cpu")
    assert primary.epoch == live_epoch
    assert isinstance(primary._index.store, ShardedCorpusStore)
    assert np.array_equal(primary._index.store.to_dense(), live_dense)
    member = DetectionService.restore(os.path.join(state, "replica-1"),
                                      device="cpu",
                                      _shared_index=primary._index)
    assert member.epoch == live_epoch
    assert member._index_shared
    assert np.array_equal(
        member.resident.values[:member.resident.n_corpus],
        primary.resident.values[:primary.resident.n_corpus])


def test_rebalance_drill_end_to_end():
    ds, p = _corpus()
    qv, qa, qp = _query(ds, q=40, seed=9)
    router = ReplicaRouter(ds, p, CFG, shard_owners=2, mode="bucketed", **KW)
    store = router.replicas[0]._index.store
    for k in range(0, 40, 8):
        router.commit(qv[k:k + 8], qa[k:k + 8], qp[k:k + 8])
    assert store.plan.imbalance() > 1.25
    assert router.rebalance(tolerance=0.25)
    n_rows = store.n_rows
    fresh_plan = make_shard_plan(n_rows, 2)
    assert np.array_equal(store.plan.bounds, fresh_plan.bounds)
    assert store.plan.imbalance() <= 1.25
    res = router.replicas[0].resident
    fresh = DetectionService(
        ClaimsDataset(values=res.values[:n_rows].copy(),
                      accuracy=res.accuracy[:n_rows].copy()),
        res.p_claim[:n_rows].copy(), CFG, mode="bucketed", n_shards=2, **KW)
    assert np.array_equal(fresh._index.store.plan.sizes(), store.plan.sizes())
    req = _req(qv[:4], qa[:4], qp[:4], rid=7)
    got, want = _serve_one(router, req), _serve_one(fresh, req)
    assert np.array_equal(got.copying, want.copying)
    np.testing.assert_allclose(got.c_fwd, want.c_fwd, rtol=2e-5, atol=1e-4)
    router.commit(qv[:8], qa[:8], qp[:8])
    store.seal(pack=True)
    assert router.rebalance(tolerance=0.0) and store.sealed
    store.unseal()
    got2 = _serve_one(router, _req(qv[:2], qa[:2], qp[:2], rid=8))
    assert got2.copying.shape == (2, router.replicas[0].resident.n_corpus)


def test_rebalance_requires_sharded_index():
    ds, p = _corpus(S=32)
    router = ReplicaRouter(ds, p, CFG, n_replicas=2, mode="bucketed", **KW)
    with pytest.raises(RuntimeError, match="sharded"):
        router.rebalance()
    with pytest.raises(ValueError, match="shard_owners"):
        ReplicaRouter(ds, p, CFG, shard_owners=0, **KW)
    with pytest.raises(ValueError, match="n_replicas"):
        ReplicaRouter(ds, p, CFG, n_replicas=0, **KW)
