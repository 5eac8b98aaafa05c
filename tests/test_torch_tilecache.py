"""The port's commit-maintained block-OR cache against the JAX package's,
and against fresh builds, on the CPU.

The load-bearing property: under any schedule of commits, retractions,
rollbacks and compactions, a ``BlockOrCache`` that followed the deltas
(rebuilding when a delta declares itself un-followable) is bit-equal to a
fresh build of the store it tracks — so the engine's tile∘chunk pruning
masks, and with them its decisions, are the same whether they came from the
cache or from a regather. One schedule also runs through both packages side
by side (the ``_Twin`` of ``tests/test_torch_mutation.py``) and compares
the two caches after every step.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
from repro.core import tilecache as jtilecache
from repro.core.types import ClaimsDataset as JDS
from repro_torch.core import (
    CopyConfig,
    DetectionEngine,
    build_index,
    commit_rows,
    index_detect_exact,
    retract_rows,
    rollback_commit,
)
from repro_torch.core.tilecache import (
    BlockOrCache,
    chunk_block_inc,
    cols_block_inc,
)
from repro_torch.core.types import ClaimsDataset
from test_torch_mutation import _Twin
from test_torch_mutation import _rows as _twin_rows
from test_torch_mutation import _world as _twin_world

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
TILE = 16


def _world(seed=0, n_src=24, n_items=96):
    rng = np.random.default_rng(seed)
    values = np.where(rng.random((n_src, n_items)) < 0.4,
                      rng.integers(0, 4, (n_src, n_items)),
                      -1).astype(np.int32)
    acc = rng.uniform(0.3, 0.95, n_src).astype(np.float32)
    p = np.where(values == 0, 0.9, 0.05).astype(np.float32)
    return ClaimsDataset(values=values, accuracy=acc), p


def _rows(rng, q, n_items):
    vals = np.where(rng.random((q, n_items)) < 0.3,
                    rng.integers(0, 4, (q, n_items)), -1).astype(np.int32)
    acc = rng.uniform(0.3, 0.95, q).astype(np.float32)
    pq = np.where(vals == 0, 0.9,
                  np.where(vals >= 0, 0.05, 0.0)).astype(np.float32)
    return vals, acc, pq


def _assert_cache_fresh(cache, store):
    fresh = BlockOrCache.build(store, TILE)
    assert cache.mseq == store.mseq
    assert cache.block_inc.shape == fresh.block_inc.shape
    np.testing.assert_array_equal(cache.block_inc, fresh.block_inc)


@pytest.mark.parametrize("chunk", [16, 40])
def test_cache_equals_jax_over_a_schedule(chunk):
    """commit (q = 6, 0), retract, commit with compaction, rollback, commit
    and a compaction through both packages: after every step both caches
    hold the same bits and masks, equal to a fresh build."""
    twin = _Twin((jcore, None, JDS), *_twin_world(chunk), chunk, capacity=60)
    caches = [BlockOrCache.build(twin.t.store, TILE),
              jtilecache.BlockOrCache.build(twin.j.store, TILE)]
    tokens = []

    def follow(receipts):
        tokens.append([c.apply(r.delta) for c, r in zip(caches, receipts)])

    def rollback():
        twin.rollback()
        for c, tok in zip(caches, tokens.pop()):
            c.undo(tok)

    steps = [
        ("commit 6", lambda: (twin.commit(*_twin_rows(1, 6, 160),
                                          compact=False),
                              twin.receipts[-1][1])),
        ("commit 0", lambda: (twin.commit(*_twin_rows(2, 0, 160),
                                          compact=False),
                              twin.receipts[-1][1])),
        ("retract", lambda: (twin.retract(np.array([3, 17, 41])),
                             twin.receipts[-1][1])),
        ("compacting commit", lambda: (
            twin.commit(*_twin_rows(3, 5, 160), compact=True,
                        compact_threshold=0.01), twin.receipts[-1][1])),
        ("rollback", None),
        ("commit 4", lambda: (twin.commit(*_twin_rows(4, 4, 160),
                                          compact=False),
                              twin.receipts[-1][1])),
    ]
    for name, step in steps:
        if step is None:
            rollback()
        else:
            follow(step())
        stores = (twin.t.store, twin.j.store)
        followed = [not c.stale and c.matches(s, TILE)
                    for c, s in zip(caches, stores)]
        # only the compacting commit and its rollback break the chain
        assert followed == [name.startswith(("commit ", "retract"))] * 2, name
        for i, (c, s) in enumerate(zip(caches, stores)):
            if not followed[i]:
                caches[i] = type(c).build(s, TILE)
        np.testing.assert_array_equal(caches[0].block_inc,
                                      caches[1].block_inc, err_msg=name)
        _assert_cache_fresh(caches[0], twin.t.store)
        order = np.random.default_rng(len(name)).integers(
            -1, twin.t.store.n_entries, 24)
        np.testing.assert_array_equal(caches[0].chunk_mask(order),
                                      caches[1].chunk_mask(order))
    twin.compact()
    assert not caches[0].matches(twin.t.store, TILE)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10_000),
       chunk_entries=st.sampled_from([8, 16, 32]),
       n_ops=st.integers(2, 6))
def test_cache_tracks_any_mutation_schedule(seed, chunk_entries, n_ops):
    """Random commit/retract/compact schedules over varying chunk widths:
    the delta-following cache stays bit-equal to a fresh build."""
    rng = np.random.default_rng(seed)
    ds, p = _world(seed)
    idx = build_index(ds, p, CFG, chunk_entries=chunk_entries,
                      row_capacity=96, device="cpu")
    values, acc = ds.values, ds.accuracy
    cache = BlockOrCache.build(idx.store, TILE)
    for _ in range(n_ops):
        op = rng.choice(["commit", "commit", "retract", "compact"])
        if op == "retract" and values.shape[0] <= 6:
            op = "commit"
        if op in ("commit", "compact"):
            q = int(rng.integers(1, 5))
            vals, a, pq = _rows(rng, q, ds.n_items)
            values = np.concatenate([values, vals])
            acc = np.concatenate([acc, a])
            p = np.concatenate([p, pq])
            idx.store.ensure_row_capacity(values.shape[0])
            info = commit_rows(idx, ClaimsDataset(values=values, accuracy=acc),
                               p, CFG, q, compact=(op == "compact"),
                               compact_threshold=0.0)
        else:
            row_ids = rng.choice(values.shape[0], int(rng.integers(1, 3)),
                                 replace=False)
            keep = np.setdiff1d(np.arange(values.shape[0]), row_ids)
            values, acc, p = values[keep], acc[keep], p[keep]
            info = retract_rows(idx, ClaimsDataset(values=values, accuracy=acc),
                                CFG, row_ids)
        cache.apply(info.delta)
        if cache.stale:
            cache = BlockOrCache.build(idx.store, TILE)
        _assert_cache_fresh(cache, idx.store)


def test_commit_apply_undo_is_bit_exact():
    """apply(commit delta) → rollback_commit → undo lands back bit-equal to
    the pre-commit incidence, re-anchored on the post-rollback mseq, and the
    chain continues."""
    ds, p = _world(5)
    idx = build_index(ds, p, CFG, chunk_entries=16, row_capacity=64,
                      device="cpu")
    cache = BlockOrCache.build(idx.store, TILE)
    before = cache.block_inc.copy()
    vals, a, pq = _rows(np.random.default_rng(6), 4, ds.n_items)
    union = ClaimsDataset(values=np.concatenate([ds.values, vals]),
                          accuracy=np.concatenate([ds.accuracy, a]))
    union_p = np.concatenate([p, pq])
    info = commit_rows(idx, union, union_p, CFG, 4, compact=False)
    token = cache.apply(info.delta)
    assert token is not None and cache.mseq == idx.store.mseq
    _assert_cache_fresh(cache, idx.store)
    rollback_commit(idx, info)
    cache.undo(token)
    np.testing.assert_array_equal(cache.block_inc, before)
    assert cache.matches(idx.store, TILE)
    info2 = commit_rows(idx, union, union_p, CFG, 4, compact=False)
    assert cache.apply(info2.delta) is not None
    _assert_cache_fresh(cache, idx.store)


def test_retract_apply_zeroes_gc_columns_everywhere():
    ds, p = _world(7, n_src=40)
    idx = build_index(ds, p, CFG, chunk_entries=16, row_capacity=48,
                      device="cpu")
    cache = BlockOrCache.build(idx.store, TILE)
    row_ids = np.array([38, 39])
    keep = np.setdiff1d(np.arange(40), row_ids)
    info = retract_rows(idx, ClaimsDataset(values=ds.values[keep],
                                           accuracy=ds.accuracy[keep]),
                        CFG, row_ids)
    assert cache.apply(info.delta) is None
    _assert_cache_fresh(cache, idx.store)
    gc = info.delta.gc_entries
    if gc is not None and len(gc):
        assert not cache.block_inc[:, np.asarray(gc)].any()


def test_cols_block_inc_matches_full_reduction():
    ds, p = _world(11, n_src=33)
    store = build_index(ds, p, CFG, chunk_entries=16, device="cpu").store
    nb = -(-store.n_rows // TILE)
    for c in range(store.n_chunks):
        full = chunk_block_inc(store, c, TILE, nb)
        np.testing.assert_array_equal(
            full, jtilecache.chunk_block_inc(store, c, TILE, nb))
        cols = np.array([0, full.shape[1] - 1, full.shape[1] // 2])
        np.testing.assert_array_equal(
            cols_block_inc(store, c, cols, TILE, nb), full[:, cols])


def test_engine_cache_hits_equal_fresh_prologue_and_exact():
    """detect → commit → detect (cache) → retract → detect (cache) →
    transient commit, detect, rollback, undo → detect (cache): every cached
    prologue equals a fresh one bit for bit, decisions equal the exact
    INDEX over a rebuild, and the cache is built once."""
    ds, p = _world(13, n_src=40, n_items=160)
    idx = build_index(ds, p, CFG, chunk_entries=16, row_capacity=64,
                      device="cpu")
    eng = DetectionEngine(CFG, tile=32, device="cpu")
    rng = np.random.default_rng(14)
    cur = [ds.values, ds.accuracy, p]

    def check(source):
        d = ClaimsDataset(values=cur[0], accuracy=cur[1])
        got = eng.detect(d, cur[2], index=idx)
        assert eng.last_stats["mask_source"] == source
        want = index_detect_exact(d, cur[2], CFG, index=build_index(
            d, cur[2], CFG, device="cpu"))
        np.testing.assert_array_equal(got.copying, want.copying)
        if source == "cache":
            cached = eng._tiled_prologue(d, cur[2], idx)
            fresh = DetectionEngine(CFG, tile=32, device="cpu")._tiled_prologue(
                d, cur[2], idx)
            assert cached.mask_source == "cache" == eng.last_stats[
                "mask_source"]
            np.testing.assert_array_equal(cached.chunk_keep, fresh.chunk_keep)
            np.testing.assert_array_equal(cached.coords, fresh.coords)

    def commit(q):
        vals, a, pq = _rows(rng, q, ds.n_items)
        cur[:] = [np.concatenate([cur[0], vals]),
                  np.concatenate([cur[1], a]), np.concatenate([cur[2], pq])]
        return commit_rows(idx, ClaimsDataset(values=cur[0], accuracy=cur[1]),
                           cur[2], CFG, q, compact=False)

    check("fresh")
    assert eng.last_stats["mask_full_builds"] == 1
    eng.apply_mask_delta(commit(5).delta)
    check("cache")
    assert eng.last_stats["mask_blocks_updated"] > 0
    row_ids = np.array([3, 17])
    keep = np.setdiff1d(np.arange(len(cur[0])), row_ids)
    cur[:] = [x[keep] for x in cur]
    eng.apply_mask_delta(retract_rows(
        idx, ClaimsDataset(values=cur[0], accuracy=cur[1]), CFG,
        row_ids).delta)
    check("cache")
    before = eng._mask_cache.block_inc.copy()
    saved = list(cur)
    info = commit(3)
    token = eng.apply_mask_delta(info.delta)
    check("cache")
    rollback_commit(idx, info)
    cur[:] = saved
    eng.undo_mask_delta(token)
    np.testing.assert_array_equal(eng._mask_cache.block_inc, before)
    check("cache")
    assert eng.last_stats["mask_full_builds"] == 1      # never rebuilt
    eng.invalidate_mask_cache()
    check("fresh")
    assert eng.last_stats["mask_full_builds"] == 2
