"""The port's index build, engine chunking and bucket deltas equal the JAX
package's on the motivating example and the S=96 world of
tests/test_engine.py; an index loaded from the JAX package's state_dict
gives the same engine chunks without a rebuild."""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest

from repro.core import index as jidx
from repro.core import scoring as jsc
from repro.core.types import CopyConfig as JCfg
from repro.data import claims as jc
from repro_torch.core import index as tidx
from repro_torch.core import scoring as tsc
from repro_torch.core.types import CopyConfig as TCfg

CFG_J = JCfg(alpha=0.1, s=0.8, n=50.0)
CFG_T = TCfg(alpha=0.1, s=0.8, n=50.0)


def _world(name):
    if name == "motivating":
        ds = jc.motivating_example()
        return ds, jc.motivating_value_probs(ds)
    sc = jc.synthetic_claims(jc.SyntheticSpec(
        n_sources=96, n_items=480, coverage="book", n_cliques=5,
        clique_size=3, clique_items=12, seed=3))
    return sc.dataset, jc.oracle_claim_probs(sc)


def _port_ds(ds):
    from repro_torch.core.types import ClaimsDataset
    return ClaimsDataset(values=ds.values.copy(), accuracy=ds.accuracy.copy())


def _assert_same_index(t, j):
    np.testing.assert_array_equal(t.store.to_dense(), j.store.to_dense())
    for name in ("entry_item", "entry_value", "entry_p", "entry_score"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.ebar_start == j.ebar_start
    np.testing.assert_array_equal(t.l_counts, j.l_counts)
    np.testing.assert_array_equal(t.items_per_source, j.items_per_source)
    assert t.store.chunk_entries == j.store.chunk_entries
    assert t.store.n_chunks == j.store.n_chunks


def _assert_same_chunks(t, j):
    for name in ("p_hat", "p_lo", "p_hi", "nout", "order"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.ebar_chunk == j.ebar_chunk
    assert t.n_live == j.n_live
    assert t.width == j.width and t.n_chunks == j.n_chunks
    for c in range(t.n_chunks):
        np.testing.assert_array_equal(t.store.chunks[c], j.store.chunks[c])


@pytest.mark.parametrize("world", ["motivating", "s96"])
@pytest.mark.parametrize("chunk_entries", [None, 8, 64])
def test_build_index_equal(world, chunk_entries):
    ds, p = _world(world)
    j = jidx.build_index(ds, p, CFG_J, chunk_entries=chunk_entries)
    t = tidx.build_index(_port_ds(ds), p, CFG_T, chunk_entries=chunk_entries,
                         device="cpu")
    _assert_same_index(t, j)


@pytest.mark.parametrize("world,n_buckets,row_capacity,max_width", [
    ("motivating", 64, 16, None),
    ("s96", 64, 96, None),
    ("s96", 7, 128, None),
    ("s96", 64, 96, 8),
])
def test_engine_chunks_equal(world, n_buckets, row_capacity, max_width):
    ds, p = _world(world)
    j = jidx.build_index(ds, p, CFG_J, chunk_entries=64)
    t = tidx.build_index(_port_ds(ds), p, CFG_T, chunk_entries=64,
                         device="cpu")
    ej = jidx.engine_chunks(j, n_buckets, row_capacity=row_capacity,
                            max_width=max_width)
    et = tidx.engine_chunks(t, n_buckets, row_capacity=row_capacity,
                            max_width=max_width)
    _assert_same_chunks(et, ej)


@pytest.mark.parametrize("world", ["motivating", "s96"])
def test_bucket_score_deltas_equal(world):
    ds, p = _world(world)
    j = jidx.engine_chunks(jidx.build_index(ds, p, CFG_J), 16)
    dj = jsc.bucket_score_deltas(j.p_hat, j.p_lo, j.p_hi, ds.accuracy, CFG_J)
    dt = tsc.bucket_score_deltas(j.p_hat, j.p_lo, j.p_hi, ds.accuracy, CFG_T)
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("world", ["motivating", "s96"])
def test_from_jax_state_dict_same_engine_chunks(world):
    ds, p = _world(world)
    j = jidx.build_index(ds, p, CFG_J, chunk_entries=32)
    t = tidx.InvertedIndex.from_state_dict(j.state_dict())
    _assert_same_index(t, j)
    _assert_same_chunks(tidx.engine_chunks(t, 16, row_capacity=128),
                        jidx.engine_chunks(j, 16, row_capacity=128))
    # and back: the port's state_dict has the JAX key set and loads there
    back = jidx.InvertedIndex.from_state_dict(t.state_dict())
    _assert_same_index(t, back)


def test_sharded_state_dict_refused():
    """A sharded capture (``store/shard_starts``) loads as a sharded store
    under its plan; one from a newer shard layout version is refused."""
    from repro_torch.core.shardplan import ShardedCorpusStore

    ds, p = _world("motivating")
    d = jidx.build_index(ds, p, CFG_J).state_dict()
    d["store/shard_starts"] = np.zeros(2, np.int64)     # version 0, one shard
    t = tidx.InvertedIndex.from_state_dict(d)
    assert isinstance(t.store, ShardedCorpusStore) and t.store.n_shards == 1
    plain = dict(d)
    del plain["store/shard_starts"]
    _assert_same_index(tidx.InvertedIndex.from_state_dict(plain), t)
    d["store/shard_starts"] = np.array([2, 0], np.int64)
    with pytest.raises(ValueError, match="newer"):
        tidx.InvertedIndex.from_state_dict(d)


def test_gather_entries_refuses_repeated_columns():
    ds, p = _world("motivating")
    t = tidx.build_index(_port_ds(ds), p, CFG_T, device="cpu")
    with pytest.raises(ValueError, match="repeats"):
        t.store.gather_entries(np.array([0, 1, 0]))
