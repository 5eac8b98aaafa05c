"""The port's store and index mutation path against the JAX package's:
commit / retract / rollback / compaction schedules leave equal state in both
packages, rollback is bit-exact, the legacy bucket views (``bucketize``,
``bucketize_engine``, ``pad_buckets``, ``slice_entries``) equal the JAX
arrays, and ``bucketed`` decisions on a committed index equal the exact
INDEX over a rebuild from the same claims.

Everything host-side is compared exactly: both packages run the same numpy
steps in the same order on the same inputs. The full-square bucket oracle
(``_bucketed_accumulate``) sums float32 products and logs: counts exact,
scores within rtol 2e-5 / atol 1e-4 (ROADMAP C4). Decisions are held
against ``index_detect_exact``, never against the JAX package's tiled engine
(ROADMAP C1).
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import (
    CopyConfig,
    DetectionEngine,
    bucketize,
    bucketize_engine,
    build_index,
    commit_rows,
    compact_index,
    index_detect_exact,
    pad_buckets,
    retract_rows,
    rollback_commit,
)
from repro_torch.core.bucketed import _bucketed_accumulate
from repro_torch.core.index import canonicalized, entry_extreme_accuracies
from repro_torch.core.types import ClaimsDataset

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
RTOL, ATOL = 2e-5, 1e-4


def _world(seed, n_src=40, n_items=160):
    rng = np.random.default_rng(seed)
    values = np.where(rng.random((n_src, n_items)) < 0.4,
                      rng.integers(0, 4, (n_src, n_items)), -1).astype(np.int32)
    acc = rng.uniform(0.3, 0.95, n_src).astype(np.float32)
    p = np.where(values == 0, 0.9, 0.05).astype(np.float32)
    return values, acc, p


def _rows(seed, q, n_items, n_vals=6):
    """q query rows; values 4 and 5 are new to the corpus, so rows that share
    them create delta entries."""
    rng = np.random.default_rng(seed)
    vals = np.where(rng.random((q, n_items)) < 0.3,
                    rng.integers(0, n_vals, (q, n_items)), -1).astype(np.int32)
    acc = rng.uniform(0.3, 0.95, q).astype(np.float32)
    p = np.where(vals == 0, 0.9, np.where(vals >= 0, 0.05, 0.0)).astype(np.float32)
    return vals, acc, p


@pytest.fixture(scope="module")
def jx():
    """The JAX package's core, with its ClaimsDataset."""
    pytest.importorskip("jax")
    import repro.core as jcore
    from repro.core.bucketed import index_detect_exact as jexact
    from repro.core.types import ClaimsDataset as JDS
    return jcore, jexact, JDS


class _Twin:
    """One claim set driven through both packages' indexes side by side."""

    def __init__(self, jx, values, acc, p, chunk, capacity):
        self.jcore, _, self.JDS = jx
        self.values, self.acc, self.p = values, acc, p
        self.t = build_index(self._ds(ClaimsDataset), p, CFG,
                             chunk_entries=chunk, row_capacity=capacity,
                             device="cpu")
        self.j = self.jcore.build_index(self._ds(self.JDS), p, CFG,
                                        chunk_entries=chunk,
                                        row_capacity=capacity)
        self.receipts = []

    def _ds(self, cls):
        return cls(values=self.values.copy(), accuracy=self.acc.copy())

    def commit(self, vals, acc, p, **kw):
        before = (self.values, self.acc, self.p)
        self.values = np.concatenate([self.values, vals])
        self.acc = np.concatenate([self.acc, acc])
        self.p = np.concatenate([self.p, p])
        q = len(vals)
        a = commit_rows(self.t, self._ds(ClaimsDataset), self.p, CFG, q, **kw)
        b = self.jcore.commit_rows(self.j, self._ds(self.JDS), self.p, CFG, q,
                                   **kw)
        for f in ("rows", "bits_set", "new_entries", "touched_entries",
                  "delta_chunks_added", "compacted", "epoch"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.touched_keys, b.touched_keys)
        np.testing.assert_array_equal(a.delta.touched, b.delta.touched)
        assert a.delta.new_entry_start == b.delta.new_entry_start
        self.receipts.append((a, b, before))
        return a

    def retract(self, row_ids):
        before = (self.values, self.acc, self.p)
        keep = np.ones(len(self.values), bool)
        keep[row_ids] = False
        self.values, self.acc, self.p = (self.values[keep], self.acc[keep],
                                         self.p[keep])
        a = retract_rows(self.t, self._ds(ClaimsDataset), CFG, row_ids)
        b = self.jcore.retract_rows(self.j, self._ds(self.JDS), CFG, row_ids)
        for f in ("rows", "touched_entries", "gc_entries",
                  "rescored_entries", "epoch"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.delta.gc_entries, b.delta.gc_entries)
        self.receipts.append((a, b, before))
        return a

    def rollback(self):
        a, b, (self.values, self.acc, self.p) = self.receipts.pop()
        rollback_commit(self.t, a)
        self.jcore.rollback_commit(self.j, b)

    def compact(self):
        compact_index(self.t, CFG)
        self.jcore.compact_index(self.j, CFG)

    def assert_equal(self):
        t, j = self.t, self.j
        ts, js = t.store, j.store
        assert (ts.n_rows, ts.capacity, ts.n_chunks, ts.chunk_entries,
                ts.delta_start, ts.epoch) == (js.n_rows, js.capacity,
                                              js.n_chunks, js.chunk_entries,
                                              js.delta_start, js.epoch)
        for a, b in zip(ts.chunks, js.chunks):
            np.testing.assert_array_equal(a, b)            # slack rows too
        for f in ("entry_item", "entry_value", "entry_p", "entry_score"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
        assert t.ebar_start == j.ebar_start
        assert (t.ebar_mask is None) == (j.ebar_mask is None)
        if t.ebar_mask is not None:
            np.testing.assert_array_equal(t.ebar_mask, j.ebar_mask)
        np.testing.assert_array_equal(t.l_counts, j.l_counts)
        np.testing.assert_array_equal(t.items_per_source, j.items_per_source)
        assert (ts.n_live_entries, ts.n_delta_entries, ts.n_delta_chunks) == (
            js.n_live_entries, js.n_delta_entries, js.n_delta_chunks)

    def claims(self):
        return ClaimsDataset(values=self.values.copy(),
                             accuracy=self.acc.copy()), self.p


def _decisions_track_rebuild(twin, jexact, JDS):
    """bucketed on the committed index == exact INDEX on a rebuild, in the
    port and in the JAX package."""
    ds, p = twin.claims()
    fresh = build_index(ds, p, CFG, device="cpu")
    want = index_detect_exact(ds, p, CFG, index=fresh).copying
    got = DetectionEngine(CFG, device="cpu", tile=16).detect(
        ds, p, index=twin.t).copying
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        index_detect_exact(ds, p, CFG, index=twin.t).copying, want)
    jds = JDS(values=ds.values.copy(), accuracy=ds.accuracy.copy())
    np.testing.assert_array_equal(jexact(jds, p, CFG).copying, want)


@pytest.mark.parametrize("chunk", [16, 40])
def test_schedule_state_equals_jax_at_every_step(jx, chunk):
    """commit (q = 6, 0, 5), retract, commit with compaction, rollback and
    a compaction: after every step both packages hold the same arrays, and
    the port's bucketed decisions equal the exact INDEX over a rebuild."""
    _, jexact, JDS = jx
    values, acc, p = _world(chunk)
    twin = _Twin(jx, values, acc, p, chunk, capacity=60)
    twin.assert_equal()
    steps = [
        lambda: twin.commit(*_rows(1, 6, 160), compact=False),
        lambda: twin.commit(*_rows(2, 0, 160), compact=False),
        lambda: twin.retract(np.array([3, 17, 41])),
        lambda: twin.commit(*_rows(3, 5, 160), compact=True,
                            compact_threshold=0.01),
        twin.rollback,
        lambda: twin.commit(*_rows(4, 4, 160), compact=False),
        twin.compact,
    ]
    for step in steps:
        step()
        twin.assert_equal()
        _decisions_track_rebuild(twin, jexact, JDS)
    assert twin.t.store.delta_start is None and twin.t.ebar_mask is None


def test_rollback_is_bit_exact_across_compaction(jx):
    values, acc, p = _world(5)
    twin = _Twin(jx, values, acc, p, 16, capacity=60)
    twin.commit(*_rows(7, 6, 160), compact=False)
    store = twin.t.store
    before = {"chunks": [c.copy() for c in store.chunks],
              "meta": [getattr(store, f).copy() for f in
                       ("entry_item", "entry_value", "entry_p", "entry_score")],
              "state": (store.n_rows, store.capacity, store.delta_start,
                        store.epoch, twin.t.ebar_start),
              "mask": twin.t.ebar_mask.copy(), "l": twin.t.l_counts.copy(),
              "ips": twin.t.items_per_source.copy()}
    info = twin.commit(*_rows(8, 6, 160), compact=True, compact_threshold=0.0)
    assert info.compacted and twin.t.store is not store
    twin.rollback()
    twin.assert_equal()
    st = twin.t.store
    assert st is store
    for a, b in zip(st.chunks, before["chunks"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip([st.entry_item, st.entry_value, st.entry_p, st.entry_score],
                    before["meta"]):
        np.testing.assert_array_equal(a, b)
    assert (st.n_rows, st.capacity, st.delta_start, st.epoch,
            twin.t.ebar_start) == before["state"]
    np.testing.assert_array_equal(twin.t.ebar_mask, before["mask"])
    np.testing.assert_array_equal(twin.t.l_counts, before["l"])
    np.testing.assert_array_equal(twin.t.items_per_source, before["ips"])


def test_retraction_gc_leaves_all_padding_chunks(jx):
    """Committed rows that share novel values only with each other create
    delta chunks; retracting them retires those entries, so whole chunks
    become padding — in both packages alike."""
    values, acc, p = _world(9)
    twin = _Twin(jx, values, acc, p, 8, capacity=60)
    vals, a, pq = _rows(10, 6, 160)
    vals[:, :40] = 4 + (np.arange(40) % 2)                 # novel, shared
    twin.commit(vals, a, pq, compact=False)
    assert twin.t.store.n_delta_chunks >= 5
    twin.retract(np.arange(40, 46))
    twin.assert_equal()
    live = [bool((ch.item >= 0).any()) for ch in twin.t.store.iter_chunks()]
    assert not all(live)


def test_store_row_mutation_and_view_memo():
    """Interleaved append/truncate land back on the corpus-only bits, a
    full-slack append then one more row raises, and chunk handles are
    memoized per (epoch, n_rows)."""
    values, acc, p = _world(3)
    idx = build_index(ClaimsDataset(values=values, accuracy=acc), p, CFG,
                      chunk_entries=16, row_capacity=52, device="cpu")
    store = idx.store
    ref = store.to_dense().copy()
    S0 = store.n_rows
    v0 = store.chunk(0)
    assert store.chunk(0) is v0
    rng = np.random.default_rng(1)
    for step in range(20):
        slack = store.capacity - store.n_rows
        if slack == 0 or (store.n_rows > S0 and rng.random() < 0.5):
            store.truncate_rows(int(rng.integers(S0, store.n_rows + 1)))
        else:
            q = int(rng.integers(0, slack + 1))
            store.append_rows(_rows(100 + step, q, 160)[0])
    store.truncate_rows(S0)
    store.append_rows(_rows(999, store.capacity - S0, 160)[0])
    assert store.chunk(0) is not v0 and store.chunk(0).V.shape[0] == 52
    with pytest.raises(ValueError, match="capacity"):
        store.append_rows(_rows(1000, 1, 160)[0])
    store.truncate_rows(S0)
    np.testing.assert_array_equal(store.to_dense(), ref)
    m0 = store.mseq
    store.ensure_row_capacity(store.capacity + 1)
    assert store.mseq == m0 and store.capacity >= 104
    np.testing.assert_array_equal(store.to_dense(), ref)


@pytest.mark.parametrize("committed", [False, True])
def test_bucket_views_equal_jax(jx, committed):
    """bucketize (fresh and committed), bucketize_engine, pad_buckets,
    slice_entries, entry_extreme_accuracies and canonicalized equal the
    JAX package's arrays."""
    jcore, _, _ = jx
    from repro.core.bucketed import pad_buckets as jpad
    from repro.core.index import (
        bucketize_engine as jbucketize_engine,
        canonicalized as jcanon,
        entry_extreme_accuracies as jextremes,
    )
    values, acc, p = _world(21)
    twin = _Twin(jx, values, acc, p, 24, capacity=60)
    if committed:
        twin.commit(*_rows(22, 6, 160), compact=False)
    t, j = twin.t, twin.j
    for nb in (5, 16):
        a, b = bucketize(t, nb), jcore.bucketize(j, nb)
        for f in ("starts", "p_hat", "m_suffix", "p_lo", "p_hi"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.ebar_bucket == b.ebar_bucket
        pa, pb = pad_buckets(a, device="cpu"), jpad(b)
        assert pa.v_ksw.dtype == torch.float32 and pa.width == pb.width
        np.testing.assert_array_equal(pa.v_ksw.numpy(), np.asarray(pb.v_ksw))
        np.testing.assert_array_equal(pa.m_suffix.numpy(),
                                      np.asarray(pb.m_suffix))
    np.testing.assert_array_equal(t.store.slice_entries(5, 77, rows=45),
                                  j.store.slice_entries(5, 77, rows=45))
    ds, _ = twin.claims()
    for a, b in zip(entry_extreme_accuracies(t.store, ds.accuracy),
                    jextremes(j.store, ds.accuracy)):
        np.testing.assert_array_equal(a, b)
    ca, cb = canonicalized(t, CFG), jcanon(j, CFG)
    assert (ca is t) == (cb is j) == (not committed)
    np.testing.assert_array_equal(ca.V, cb.V)
    if not committed:
        (a, lo, hi), (b, jlo, jhi) = (bucketize_engine(t, 12),
                                      jbucketize_engine(j, 12))
        for x, y in ((a.starts, b.starts), (a.p_hat, b.p_hat),
                     (a.m_suffix, b.m_suffix), (lo, jlo), (hi, jhi),
                     (a.index.V, b.index.V)):
            np.testing.assert_array_equal(x, y)
        assert a.ebar_bucket == b.ebar_bucket


def test_bucketed_accumulate_matches_jax(jx):
    """The full-square bucket oracle in torch against the JAX one: counts
    exact, C→ within C4's tolerance."""
    from repro.core.bucketed import _bucketed_accumulate as jacc
    from repro.core.bucketed import pad_buckets as jpad
    jcore, _, _ = jx
    values, acc, p = _world(31)
    twin = _Twin(jx, values, acc, p, 32, capacity=40)
    a, b = bucketize(twin.t, 8), jcore.bucketize(twin.j, 8)
    pa, pb = pad_buckets(a, device="cpu"), jpad(b)
    got = _bucketed_accumulate(pa.v_ksw, pa.p_hat, acc, CFG.s, CFG.n,
                               pa.ebar_bucket)
    want = jacc(pb.v_ksw, pb.p_hat, acc, CFG.s, CFG.n, pb.ebar_bucket)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       sizes=st.lists(st.integers(0, 5), min_size=1, max_size=3),
       retract=st.booleans(),
       compact=st.booleans(),
       chunk=st.integers(8, 48))
def test_random_schedules_track_rebuild(seed, sizes, retract, compact, chunk):
    """After every step of a random schedule (sizes including 0, random
    rows, an optional retraction, compaction on or off, random chunk
    widths) the exact INDEX on the committed index decides like a rebuild
    from the same claims."""
    values, acc, p = _world(seed, n_src=22, n_items=70)
    ds = ClaimsDataset(values=values, accuracy=acc)
    idx = build_index(ds, p, CFG, chunk_entries=chunk,
                      row_capacity=22 + sum(sizes), device="cpu")
    rng = np.random.default_rng(seed + 1)
    for step, q in enumerate(sizes):
        vals, a, pq = _rows(int(rng.integers(1 << 30)), q, 70)
        values = np.concatenate([values, vals])
        acc = np.concatenate([acc, a])
        p = np.concatenate([p, pq])
        commit_rows(idx, ClaimsDataset(values=values, accuracy=acc), p, CFG,
                    q, compact=compact, compact_threshold=0.2)
        if retract and step == 0:
            gone = rng.choice(len(values), size=2, replace=False)
            keep = np.ones(len(values), bool)
            keep[gone] = False
            values, acc, p = values[keep], acc[keep], p[keep]
            retract_rows(idx, ClaimsDataset(values=values, accuracy=acc), CFG,
                         gone)
        union = ClaimsDataset(values=values, accuracy=acc)
        fresh = build_index(union, p, CFG, device="cpu")
        np.testing.assert_array_equal(
            index_detect_exact(union, p, CFG, index=idx).copying,
            index_detect_exact(union, p, CFG, index=fresh).copying,
            err_msg=f"diverged at step {step}")
