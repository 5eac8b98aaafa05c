"""The port's row-range shard plane against the JAX package's.

A twin of each package's ``ShardedCorpusStore`` is built from the same
numpy store under the same plan, and every read (``chunk``,
``assemble_rows``, ``block_or``, ``slice_entries``, ``cooccurrence``,
``column``, ``gather_entries``) is compared exactly — before and after
``seal`` with bitpacking and spill — as are plans, a commit / retract /
rebalance / rollback schedule through both packages' indexes, snapshots and
state dicts. Bitpacking, the partial merges, the spill frames (readable
across packages) and the corrupt-frame fallback are held here too. All of
it is host numpy in both packages, so the bar is equality.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import os
import tempfile

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import (
    CopyConfig,
    CorpusStore,
    InvertedIndex,
    OwnerPartial,
    SealedShardError,
    ShardedCorpusStore,
    ShardPlan,
    SpillCorruptionError,
    build_index,
    commit_rows,
    compact_index,
    make_shard_plan,
    merge_owner_partials,
    merge_shard_partials,
    pack_membership,
    packed_count_matmul,
    rebalance_plan,
    retract_rows,
    rollback_commit,
    shard_store,
    unpack_membership,
)
from repro_torch.core import wal
from repro_torch.core.types import ClaimsDataset

CE = 16                 # chunk width (a multiple of 8): multi-chunk stores
CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
ODD_WIDTHS = [1, 3, 7, 8, 9, 13, 16, 27, 64, 100]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's shard plane, store, index and wal modules."""
    pytest.importorskip("jax")
    import repro.core as jcore
    import repro.core.index  # noqa: F401  (jcore.index)
    import repro.core.shardplan as jshard
    import repro.core.store as jstore
    import repro.core.wal as jwal
    from repro.core.types import ClaimsDataset as JDS
    return jcore, jshard, jstore, jwal, JDS


def _random_arrays(rng, n_rows, n_entries):
    dense = (rng.random((n_rows, n_entries)) < 0.3).astype(np.int8)
    meta = dict(
        entry_item=rng.integers(0, 40, n_entries).astype(np.int32),
        entry_value=rng.integers(0, 5, n_entries).astype(np.int32),
        entry_p=rng.random(n_entries).astype(np.float32),
        entry_score=rng.random(n_entries).astype(np.float32))
    return dense, meta


def _store(cls, dense, meta, capacity=None):
    n_rows, n_entries = dense.shape
    cap = n_rows if capacity is None else capacity
    chunks = []
    for i in range(0, n_entries, CE):
        blk = np.zeros((cap, min(CE, n_entries - i)), np.int8)
        blk[:n_rows] = dense[:, i: i + CE]
        chunks.append(blk)
    return cls(chunks=chunks, chunk_entries=CE, n_rows=n_rows, capacity=cap,
               **{k: v.copy() for k, v in meta.items()})


def _random_bounds(rng, n_rows, n_shards):
    """Random cuts: uneven, empty and single-row shards."""
    cuts = np.sort(rng.integers(0, n_rows + 1, n_shards - 1))
    return np.concatenate(([0], cuts, [n_rows]))


def _twin(jx, seed, n_rows=None, n_shards=None):
    """(dense, port sharded store, JAX sharded store) under one plan."""
    _, jshard, jstore, _, _ = jx
    rng = np.random.default_rng(seed)
    n_rows = int(rng.integers(1, 80)) if n_rows is None else n_rows
    n_shards = int(rng.integers(1, 6)) if n_shards is None else n_shards
    n_entries = int(rng.integers(1, 4)) * CE - int(rng.integers(0, 8))
    dense, meta = _random_arrays(rng, n_rows, n_entries)
    bounds = _random_bounds(rng, n_rows, n_shards)
    t = shard_store(_store(CorpusStore, dense, meta), ShardPlan(bounds=bounds))
    j = jshard.shard_store(_store(jstore.CorpusStore, dense, meta),
                           jshard.ShardPlan(bounds=bounds))
    return rng, dense, t, j


def _assert_reads_equal(rng, t, j, tile):
    """Every read of the two facades returns the same arrays."""
    n_blocks = -(-max(t.n_rows, 1) // tile)
    assert (t.n_rows, t.n_chunks, t.n_entries, t.capacity) == (
        j.n_rows, j.n_chunks, j.n_entries, j.capacity)
    np.testing.assert_array_equal(t.plan.bounds, j.plan.bounds)
    for c in range(t.n_chunks):
        a, b = t.chunk(c), j.chunk(c)
        assert a.start == b.start
        for f in ("V", "item", "value", "p", "score"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(t.block_or(c, tile, n_blocks),
                                      j.block_or(c, tile, n_blocks))
        r0 = int(rng.integers(0, t.n_rows + 1))
        r1 = r0 + int(rng.integers(1, 3 * tile))
        np.testing.assert_array_equal(t.assemble_rows(c, r0, r1),
                                      j.assemble_rows(c, r0, r1))
    e0 = int(rng.integers(0, t.n_entries))
    e1 = int(rng.integers(e0, t.n_entries)) + 1
    np.testing.assert_array_equal(t.slice_entries(e0, e1),
                                  j.slice_entries(e0, e1))
    np.testing.assert_array_equal(t.slice_entries(e0, e1, rows=t.n_rows + 3),
                                  j.slice_entries(e0, e1, rows=j.n_rows + 3))
    e = int(rng.integers(0, t.n_entries))
    np.testing.assert_array_equal(t.column(e), j.column(e))
    np.testing.assert_array_equal(t.providers(e), j.providers(e))
    np.testing.assert_array_equal(t.cooccurrence(), j.cooccurrence())
    stop = int(rng.integers(0, t.n_entries + 1))
    np.testing.assert_array_equal(t.cooccurrence(stop=stop),
                                  j.cooccurrence(stop=stop))
    mask = rng.random(t.n_entries) < 0.5
    np.testing.assert_array_equal(t.cooccurrence(mask=mask),
                                  j.cooccurrence(mask=mask))
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())


# ---------------------------------------------------------------------------
# Bitpacking (the counterpart of tests/test_bitpack.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", ODD_WIDTHS)
def test_pack_unpack_identity_any_width(jx, width):
    jstore = jx[2]
    rng = np.random.default_rng(width)
    block = (rng.random((17, width)) < 0.4).astype(np.int8)
    packed = pack_membership(block)
    assert packed.width == width
    assert packed.bits.shape == (17, -(-width // 8))
    np.testing.assert_array_equal(unpack_membership(packed), block)
    # pad bits of the last byte are zero: no phantom members for AND/popcount
    assert not np.unpackbits(packed.bits, axis=1)[:, width:].any()
    np.testing.assert_array_equal(packed.bits,
                                  jstore.pack_membership(block).bits)


@pytest.mark.parametrize("fill", [0, 1])
def test_pack_unpack_all_zero_all_one(fill):
    for width in (5, 8, 21):
        block = np.full((9, width), fill, np.int8)
        np.testing.assert_array_equal(
            unpack_membership(pack_membership(block)), block)


def test_pack_refuses_non_2d_and_width_mismatch():
    with pytest.raises(ValueError):
        pack_membership(np.zeros(8, np.int8))
    a = pack_membership(np.zeros((2, 8), np.int8))
    b = pack_membership(np.zeros((2, 9), np.int8))
    with pytest.raises(ValueError, match="width mismatch"):
        packed_count_matmul(a, b)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 30),
       m=st.integers(1, 30), width=st.integers(1, 60),
       density=st.floats(0.0, 1.0))
def test_packed_count_matmul_equals_int8_product(seed, n, m, width, density):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, width)) < density).astype(np.int8)
    b = (rng.random((m, width)) < 0.4).astype(np.int8)
    pa, pb = pack_membership(a), pack_membership(b)
    np.testing.assert_array_equal(unpack_membership(pa), a)
    want = a.astype(np.float32) @ b.T.astype(np.float32)
    np.testing.assert_array_equal(packed_count_matmul(pa, pb), want)
    np.testing.assert_array_equal(packed_count_matmul(pa, pb, row_block=3),
                                  want)
    np.testing.assert_array_equal(packed_count_matmul(pa),
                                  a.astype(np.float32) @ a.T.astype(np.float32))


# ---------------------------------------------------------------------------
# Plans and merges
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n_rows=st.integers(0, 300),
       n_shards=st.integers(1, 7))
def test_plans_equal_jax(jx, seed, n_rows, n_shards):
    jshard = jx[1]
    plan, jplan = (make_shard_plan(n_rows, n_shards),
                   jshard.make_shard_plan(n_rows, n_shards))
    np.testing.assert_array_equal(plan.bounds, jplan.bounds)
    assert max(plan.sizes(), default=0) - min(plan.sizes(), default=0) <= 1
    rng = np.random.default_rng(seed)
    bounds = _random_bounds(rng, n_rows, n_shards)
    ours = ShardPlan(bounds=bounds)
    theirs = jshard.ShardPlan(bounds=bounds)
    assert ours.imbalance() == theirs.imbalance()
    for r in rng.integers(0, n_rows + 3, 8):
        assert ours.owner_of_row(r) == theirs.owner_of_row(r)
        s = ours.owner_of_row(r)
        assert ours.range_of(s) == theirs.range_of(s)
    grown = n_rows + int(rng.integers(0, 40))
    np.testing.assert_array_equal(
        rebalance_plan(ours, grown).bounds,
        jshard.rebalance_plan(theirs, grown).bounds)
    with pytest.raises(ValueError):
        ShardPlan(bounds=np.array([1, 2]))
    with pytest.raises(ValueError):
        make_shard_plan(4, 0)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n_shards=st.integers(1, 5),
       s_pad=st.integers(1, 24))
def test_merge_shard_partials_equals_jax(jx, seed, n_shards, s_pad):
    jshard = jx[1]
    rng = np.random.default_rng(seed)
    partials = [tuple([rng.integers(0, 99, (s_pad, s_pad)).astype(np.float32)
                       for _ in range(3)]
                      + [rng.random((s_pad, s_pad)).astype(np.float32)])
                for _ in range(n_shards)]
    ours = merge_shard_partials(partials)
    theirs = jshard.merge_shard_partials(partials)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), b)
    # counts sum, the p̂-error bound takes the max
    np.testing.assert_array_equal(
        ours[3].numpy(), np.stack([q[3] for q in partials]).max(axis=0))
    assert all(not g.any() for g in merge_shard_partials([], (s_pad, s_pad)))
    with pytest.raises(ValueError):
        merge_shard_partials([])


@pytest.mark.parametrize("seed", range(4))
def test_merge_owner_partials_equals_jax(jx, seed):
    """Random owner partials over a partition of the r ≤ c tiles: the
    port's one scatter equals JAX's sum/max merge of full grids, and equals
    ``merge_shard_partials`` over its own ``to_grids``."""
    jshard = jx[1]
    rng = np.random.default_rng(seed)
    nb, T, n_own = int(rng.integers(1, 5)), 8, int(rng.integers(1, 5))
    tiles = np.argwhere(np.triu(rng.random((nb, nb)) < 0.7)).astype(np.int32)
    owner = rng.integers(0, n_own, len(tiles))
    ours, theirs = [], []
    for o in rng.permutation(n_own):
        coords = tiles[owner == o]
        stacks = [rng.integers(0, 9, (len(coords), T, T)).astype(np.float32)
                  for _ in range(4)] + [
                      rng.random((len(coords), T, T)).astype(np.float32)]
        ours.append(OwnerPartial(int(o), nb, T, coords,
                                 [torch.from_numpy(x) for x in stacks]))
        theirs.append(jshard.OwnerPartial(int(o), nb, T, coords, stacks))
    got = merge_owner_partials(ours, nb, T)
    for a, b in zip(got, jshard.merge_owner_partials(theirs, nb, T)):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(got, merge_shard_partials([q.to_grids() for q in ours])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="exactly once"):
        merge_owner_partials(ours[:-1] if n_own > 1 else ours + ours, nb, T)
    with pytest.raises(ValueError, match="exactly once"):
        merge_owner_partials(ours + ours[:1], nb, T)


# ---------------------------------------------------------------------------
# The facade: reads, seal, gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_reads_equal_jax_before_and_after_seal(jx, seed):
    rng, dense, t, j = _twin(jx, seed)
    tile = int(rng.integers(1, 20))
    _assert_reads_equal(rng, t, j, tile)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        cap = int(rng.integers(1, 200))
        t.seal(pack=True, spill_dir=d1, resident_bytes=cap)
        j.seal(pack=True, spill_dir=d2, resident_bytes=cap)
        assert t.sealed and j.sealed
        _assert_reads_equal(rng, t, j, tile)
        # every block spilled, twice: reloads stay bit-exact
        for _ in range(2):
            for s in range(t.n_shards):
                for c in range(t.n_chunks):
                    t.evict_block(s, c)
            np.testing.assert_array_equal(t.to_dense(), dense)
        order = rng.integers(-1, t.n_entries, int(rng.integers(1, 2 * CE)))
        gt, gj = t.gather_entries(order), j.gather_entries(order)
        assert gt.n_shards == gj.n_shards == t.n_shards
        for f in ("entry_item", "entry_value", "entry_p", "entry_score"):
            np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f))
        _assert_reads_equal(rng, gt, gj, tile)
        t.unseal()
        j.unseal()
    assert not t.sealed
    _assert_reads_equal(rng, t, j, tile)


@pytest.mark.parametrize("seed", range(6))
def test_gather_equals_jax_with_repeats_capacity_and_chunking(jx, seed):
    """``gather_entries`` (−1 markers and repeated columns in ``order``, a
    new chunk width and capacity) equals JAX's; streaming the seal through
    it changes nothing read and keeps every shard under its cap plus one
    block."""
    rng, dense, t, j = _twin(jx, 100 + seed)
    order = rng.integers(-1, t.n_entries, int(rng.integers(1, 4 * CE)))
    ce, cap = 8 * int(rng.integers(1, 4)), t.n_rows + int(rng.integers(0, 9))
    gt = t.gather_entries(order, chunk_entries=ce, capacity=cap)
    gj = j.gather_entries(order, chunk_entries=ce, capacity=cap)
    _assert_reads_equal(rng, gt, gj, 4)
    for s in range(gt.n_shards):
        for c in range(gt.n_chunks):
            np.testing.assert_array_equal(gt._slices[s].blocks[c],
                                          gj._slices[s].blocks[c])
    budget = int(rng.integers(1, 64))
    with tempfile.TemporaryDirectory() as d:
        gs = t.gather_entries(order, chunk_entries=ce, capacity=cap,
                              pack=True, spill_dir=d, resident_bytes=budget)
        assert gs.sealed
        block = max(sl._block_bytes(pack_membership(b))
                    for sl in gt._slices for b in sl.blocks) if gt.n_chunks \
            else 0
        assert max(gs.shard_peak_bytes()) <= budget + block
        _assert_reads_equal(rng, gs, gj, 4)


def test_streaming_shard_store_stays_under_its_cap(jx):
    """``shard_store(pack, spill, resident_bytes, consume)`` seals while it
    slices: sealed on return, every shard's peak under the cap plus one
    packed block, the source chunks released, every read bit-exact."""
    jshard, jstore = jx[1], jx[2]
    rng = np.random.default_rng(11)
    dense, meta = _random_arrays(rng, 70, 5 * CE)
    base = _store(CorpusStore, dense, meta)
    with tempfile.TemporaryDirectory() as d:
        t = shard_store(base, make_shard_plan(70, 3), pack=True, spill_dir=d,
                        resident_bytes=40, consume=True)
        assert t.sealed and all(c is None for c in base.chunks)
        with pytest.raises(RuntimeError, match="released"):
            base.chunk(0)
        assert max(t.shard_peak_bytes()) <= 40 + 24 * 2
        assert t.spill_stats()["spill_writes"] > 0
        j = jshard.shard_store(_store(jstore.CorpusStore, dense, meta),
                               jshard.make_shard_plan(70, 3))
        _assert_reads_equal(rng, t, j, 8)
        assert t.spill_stats()["reloads"] > 0
        with pytest.raises(SealedShardError):
            t.append_rows(np.zeros((1, 4), np.int32))


# ---------------------------------------------------------------------------
# Spill frames and corruption (the counterpart of test_shard_faults.py)
# ---------------------------------------------------------------------------

def test_spill_frames_are_readable_across_packages(jx, tmp_path):
    jwal = jx[3]
    arrays = {"bits": np.arange(24, dtype=np.uint8).reshape(3, 8),
              "meta": np.array([1, 3, 61], np.int64)}
    ours = wal.write_framed(str(tmp_path / "a.spill"), arrays,
                            magic=wal.SPILL_MAGIC, fsync=False)
    theirs = jwal.write_framed(str(tmp_path / "b.spill"), arrays,
                               magic=jwal.SPILL_MAGIC, fsync=False)
    # one header layout: magic, version, reserved (the npz payload carries
    # its own zip timestamps)
    assert open(ours, "rb").read()[:8] == open(theirs, "rb").read()[:8]
    for path in (ours, theirs):
        for load in (wal.load_framed, jwal.load_framed):
            got = load(path, magic=wal.SPILL_MAGIC)
            for k, v in arrays.items():
                np.testing.assert_array_equal(got[k], v)
    # a spilled block of the port's store loads in the JAX package
    rng = np.random.default_rng(5)
    dense, meta = _random_arrays(rng, 20, 2 * CE)
    t = shard_store(_store(CorpusStore, dense, meta), 2)
    t.seal(pack=True, spill_dir=str(tmp_path))
    t.evict_block(1, 0)
    got = jwal.load_framed(t._slices[1].blocks[0].path,
                           magic=jwal.SPILL_MAGIC)
    np.testing.assert_array_equal(got["meta"], [1, 10, CE])
    np.testing.assert_array_equal(
        np.unpackbits(got["bits"], axis=1, count=CE), dense[10:, :CE])
    with pytest.raises(wal.WalError, match="magic"):
        wal.load_framed(ours)


@pytest.mark.parametrize("corruption", ["torn", "crc"])
def test_spill_corruption_regathers_from_source(tmp_path, corruption):
    rng = np.random.default_rng(3)
    dense, meta = _random_arrays(rng, 48, 40)
    base = _store(CorpusStore, dense, meta)
    sh = shard_store(base, 3)
    order = rng.integers(-1, base.n_entries, 32)
    g = sh.gather_entries(order)
    want = g.to_dense()
    g.seal(pack=True, spill_dir=str(tmp_path))
    for s in range(g.n_shards):
        for c in range(g.n_chunks):
            g.evict_block(s, c)
    path = g._slices[1].blocks[0].path
    blob = open(path, "rb").read()
    if corruption == "torn":                 # a write cut short
        open(path, "wb").write(blob[: max(4, len(blob) // 2)])
    else:                                    # bit rot: CRC mismatch
        body = bytearray(blob)
        body[len(body) // 2] ^= 0xFF
        open(path, "wb").write(bytes(body))
    with pytest.raises(wal.WalError):
        wal.load_framed(path, magic=wal.SPILL_MAGIC)
    np.testing.assert_array_equal(g.to_dense(), want)      # regathered
    # the frame was healed: another evict/reload cycle reads it back
    wal.load_framed(path, magic=wal.SPILL_MAGIC)
    g.evict_block(1, 0)
    np.testing.assert_array_equal(g.to_dense(), want)


def test_spill_corruption_without_source_is_typed(tmp_path):
    rng = np.random.default_rng(4)
    dense, meta = _random_arrays(rng, 48, 40)
    sh = shard_store(_store(CorpusStore, dense, meta), 2)  # no source
    sh.seal(pack=False, spill_dir=str(tmp_path))
    sh.evict_block(0, 0)
    path = sh._slices[0].blocks[0].path
    open(path, "wb").write(b"\x00garbage, not a spill frame")
    with pytest.raises(SpillCorruptionError):
        sh.assemble_rows(0, 0, sh.n_rows)
    r0, r1 = sh.plan.range_of(1)                 # the other shard still reads
    np.testing.assert_array_equal(sh.assemble_rows(1, r0, r1),
                                  dense[r0:r1, 16:32])


def test_two_stores_never_share_spill_frames(tmp_path):
    """Each sealed store spills into a directory of its own, so two stores
    sealed under one ``spill_dir`` never read each other's frames."""
    rng = np.random.default_rng(8)
    stores = []
    for _ in range(2):
        dense, meta = _random_arrays(rng, 30, 2 * CE)
        sh = shard_store(_store(CorpusStore, dense, meta), 2)
        sh.seal(pack=True, spill_dir=str(tmp_path), resident_bytes=1)
        stores.append((dense, sh))
    for dense, sh in stores:
        np.testing.assert_array_equal(sh.to_dense(), dense)
    assert len(os.listdir(tmp_path)) == 2


# ---------------------------------------------------------------------------
# Mutation, snapshot, rebalance, state dict
# ---------------------------------------------------------------------------

def _world(seed, n_src=40, n_items=120):
    rng = np.random.default_rng(seed)
    values = np.where(rng.random((n_src, n_items)) < 0.4,
                      rng.integers(0, 4, (n_src, n_items)), -1).astype(np.int32)
    acc = rng.uniform(0.3, 0.95, n_src).astype(np.float32)
    p = np.where(values == 0, 0.9, 0.05).astype(np.float32)
    return values, acc, p


def _rows(seed, q, n_items):
    rng = np.random.default_rng(seed)
    vals = np.where(rng.random((q, n_items)) < 0.3,
                    rng.integers(0, 6, (q, n_items)), -1).astype(np.int32)
    acc = rng.uniform(0.3, 0.95, q).astype(np.float32)
    p = np.where(vals == 0, 0.9, np.where(vals >= 0, 0.05, 0.0)
                 ).astype(np.float32)
    return vals, acc, p


class _ShardedTwin:
    """One claim set driven through both packages' sharded indexes."""

    def __init__(self, jx, seed, bounds, capacity=64):
        self.jcore, self.jshard, _, _, self.JDS = jx
        self.values, self.acc, self.p = _world(seed)
        self.t = build_index(self._ds(ClaimsDataset), self.p, CFG,
                             chunk_entries=CE, row_capacity=capacity,
                             device="cpu")
        self.j = self.jcore.build_index(self._ds(self.JDS), self.p, CFG,
                                        chunk_entries=CE,
                                        row_capacity=capacity)
        self.t.store = shard_store(self.t.store, ShardPlan(bounds=bounds))
        self.j.store = self.jshard.shard_store(
            self.j.store, self.jshard.ShardPlan(bounds=bounds))
        self.receipts = []

    def _ds(self, cls):
        return cls(values=self.values.copy(), accuracy=self.acc.copy())

    def commit(self, vals, acc, p, **kw):
        before = (self.values, self.acc, self.p)
        self.values = np.concatenate([self.values, vals])
        self.acc = np.concatenate([self.acc, acc])
        self.p = np.concatenate([self.p, p])
        a = commit_rows(self.t, self._ds(ClaimsDataset), self.p, CFG,
                        len(vals), **kw)
        b = self.jcore.commit_rows(self.j, self._ds(self.JDS), self.p, CFG,
                                   len(vals), **kw)
        assert (a.bits_set, a.new_entries, a.compacted) == (
            b.bits_set, b.new_entries, b.compacted)
        self.receipts.append((a, b, before))

    def retract(self, row_ids):
        before = (self.values, self.acc, self.p)
        keep = np.ones(len(self.values), bool)
        keep[row_ids] = False
        self.values, self.acc, self.p = (self.values[keep], self.acc[keep],
                                         self.p[keep])
        a = retract_rows(self.t, self._ds(ClaimsDataset), CFG, row_ids)
        b = self.jcore.retract_rows(self.j, self._ds(self.JDS), CFG, row_ids)
        assert (a.gc_entries, a.rescored_entries) == (b.gc_entries,
                                                      b.rescored_entries)
        self.receipts.append((a, b, before))

    def rollback(self):
        a, b, (self.values, self.acc, self.p) = self.receipts.pop()
        rollback_commit(self.t, a)
        self.jcore.rollback_commit(self.j, b)

    def rebalance(self):
        assert self.t.store.rebalance(0.0) == self.j.store.rebalance(0.0)

    def compact(self):
        compact_index(self.t, CFG)
        self.jcore.compact_index(self.j, CFG)

    def assert_equal(self, rng):
        ts, js = self.t.store, self.j.store
        assert isinstance(ts, ShardedCorpusStore)
        assert (ts.delta_start, ts.epoch, ts.n_delta_chunks) == (
            js.delta_start, js.epoch, js.n_delta_chunks)
        for f in ("entry_item", "entry_value", "entry_p", "entry_score"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
        for s in range(ts.n_shards):                 # slack rows too
            for a, b in zip(ts._slices[s].blocks, js._slices[s].blocks):
                np.testing.assert_array_equal(a, b)
        _assert_reads_equal(rng, ts, js, 8)
        np.testing.assert_array_equal(self.t.l_counts, self.j.l_counts)
        assert (self.t.ebar_mask is None) == (self.j.ebar_mask is None)
        if self.t.ebar_mask is not None:
            np.testing.assert_array_equal(self.t.ebar_mask, self.j.ebar_mask)


@pytest.mark.parametrize("seed", range(3))
def test_mutation_schedule_equals_jax(jx, seed):
    """commit, commit, retract, rollback, rebalance, commit with compaction,
    truncate: after every step both packages' sharded indexes hold the same
    arrays, shard by shard."""
    rng = np.random.default_rng(seed)
    twin = _ShardedTwin(jx, seed, _random_bounds(rng, 40, 3))
    twin.assert_equal(rng)
    steps = [
        lambda: twin.commit(*_rows(seed + 1, 6, 120), compact=False),
        lambda: twin.commit(*_rows(seed + 2, 3, 120), compact=False),
        lambda: twin.retract(np.array([1, 20, 44])),
        twin.rollback,
        twin.rebalance,
        lambda: twin.commit(*_rows(seed + 3, 5, 120), compact=True,
                            compact_threshold=0.01),
        twin.rollback,
        twin.compact,
    ]
    for step in steps:
        step()
        twin.assert_equal(rng)
    ts, js = twin.t.store, twin.j.store
    ts.ensure_row_capacity(ts.capacity + 7)
    js.ensure_row_capacity(js.capacity + 7)
    ts.append_rows(_rows(9, 2, 120)[0])
    js.append_rows(_rows(9, 2, 120)[0])
    ts.truncate_rows(ts.n_rows - 1)
    js.truncate_rows(js.n_rows - 1)
    twin.assert_equal(rng)


def test_snapshot_restore_equals_jax(jx):
    rng = np.random.default_rng(21)
    _, dense, t, j = _twin(jx, 21, n_rows=50, n_shards=4)
    snaps = (t.snapshot(), j.snapshot())
    mseq = t.mseq
    for st in (t, j):
        st.retract_rows(np.array([0, 13, 49]))
        st.deactivate_entries(np.array([0, st.n_entries - 1]))
        st.rebalance(0.0)
    _assert_reads_equal(rng, t, j, 8)
    for sn in snaps:
        sn.restore()
    assert t.mseq != mseq
    np.testing.assert_array_equal(t.to_dense(), dense)
    _assert_reads_equal(rng, t, j, 8)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_sharded_index_state_loads_across_packages(jx, n_shards):
    """A JAX-written sharded index state loads in the port's
    ``InvertedIndex.from_state_dict`` (same plan, same arrays), and the
    port's in the JAX package's."""
    jcore, jshard, _, _, JDS = jx
    values, acc, p = _world(5)
    jidx = jcore.build_index(JDS(values=values, accuracy=acc), p, CFG,
                             chunk_entries=CE)
    bounds = np.array([0, 7, 7, 40][: n_shards] + [40])
    jidx.store = jshard.shard_store(jidx.store, jshard.ShardPlan(bounds=bounds))
    t = InvertedIndex.from_state_dict(jidx.state_dict())
    assert isinstance(t.store, ShardedCorpusStore)
    np.testing.assert_array_equal(t.store.plan.bounds, jidx.store.plan.bounds)
    _assert_reads_equal(np.random.default_rng(0), t.store, jidx.store, 8)
    np.testing.assert_array_equal(t.l_counts, jidx.l_counts)
    back = jcore.index.InvertedIndex.from_state_dict(t.state_dict())
    assert isinstance(back.store, jshard.ShardedCorpusStore)
    np.testing.assert_array_equal(back.store.plan.bounds, bounds)
    np.testing.assert_array_equal(back.store.to_dense(), t.store.to_dense())
