"""The frozen generator draws what the program's generator draws, and the
seed's relabelling keeps the work."""
import numpy as np
import pytest
import torch

from cdbench import data
from cdbench.reference import CopyModel, square_scores
from repro_torch.data import claims as port

SPECS = [dict(n_sources=120, n_items=300, n_cliques=5, seed=7),
         dict(n_sources=90, n_items=200, n_cliques=4, clique_items=12, seed=3),
         dict(n_sources=60, n_items=400, n_cliques=3, coverage="stock", seed=11)]


@pytest.mark.parametrize("kw", SPECS)
def test_synthetic_claims_equal_the_programs(kw):
    ours = data.synthetic_claims(data.SyntheticSpec(**kw))
    theirs = port.synthetic_claims(port.SyntheticSpec(**kw))
    np.testing.assert_array_equal(ours.values, theirs.dataset.values)
    np.testing.assert_array_equal(ours.accuracy, theirs.dataset.accuracy)
    assert ours.copies == theirs.copies
    assert ours.copy_edges == theirs.copy_edges
    np.testing.assert_array_equal(data.oracle_claim_probs(ours.values),
                                  port.oracle_claim_probs(theirs))


def test_book_full_spec_equals_the_programs():
    assert vars(data.book_full_spec(5)) == vars(port.book_full_spec(5))


def _world(**kw):
    return data.synthetic_claims(data.SyntheticSpec(**kw))


@pytest.mark.parametrize("seed", [0, [4, 1, 2]])
def test_new_sources_are_drawn_as_the_worlds_sources(seed):
    spec = data.SyntheticSpec(n_sources=120, n_items=2000, n_cliques=20,
                              seed=5)
    w = data.synthetic_claims(spec)
    v, a, origins = data.new_sources(w, spec, 400, seed)
    again = data.new_sources(w, spec, 400, seed,
                             claims_per_source=(w.values >= 0).sum(1))
    for x, y in zip((v, a, origins), again):
        np.testing.assert_array_equal(x, y)
    assert ((a >= spec.acc_low) & (a <= spec.acc_high)).all()
    # the coverage profile of the world's own sources
    own = (v[origins < 0] >= 0).sum(1) / spec.n_items
    assert own.min() >= 0.002 and own.max() <= 0.92
    ref = (w.values >= 0).sum(1) / spec.n_items
    assert 0.5 < np.median(own) / np.median(ref) < 2.0
    # copiers at the planted share, each taking about copy_selectivity of
    # an original's claims
    share = spec.n_cliques * (spec.clique_size - 1) / spec.n_sources
    assert abs((origins >= 0).mean() - share) < 0.08
    for r in np.nonzero(origins >= 0)[0]:
        o_idx = np.nonzero(w.values[origins[r]] >= 0)[0]
        same = (v[r, o_idx] == w.values[origins[r], o_idx]).mean()
        assert same >= 0.5 and o_idx.size >= 20


def test_truth_tables():
    w = _world(n_sources=150, n_items=400, n_cliques=4, seed=2)
    oracle = data.truth_table(w.values, w.accuracy, 50, "oracle")
    np.testing.assert_array_equal(data.claim_probs(w.values, oracle),
                                  data.oracle_claim_probs(w.values))
    vote = data.truth_table(w.values, w.accuracy, 50, "vote")
    assert vote.shape == (400, 51) and vote.dtype == np.float32
    assert (vote >= data.P_CLIP).all() and (vote <= 1 - data.P_CLIP).all()
    p = data.claim_probs(w.values, vote)
    assert (p[w.values < 0] == 0).all()
    # continuous: far more than the oracle's two values, and the truth
    # mostly on top
    assert np.unique(p[w.values >= 0]).size > 50
    assert np.median(p[w.values == 0]) > 0.9 > 0.1 > np.median(p[w.values > 0])
    with pytest.raises(ValueError):
        data.truth_table(w.values, w.accuracy, 50, "guess")


def test_relabel_is_a_renumbering_of_the_same_world():
    w = data.synthetic_claims(data.SyntheticSpec(n_sources=70, n_items=150,
                                                 n_cliques=3, seed=1))
    rl = data.relabel(2**31 + 17, 70, 150, 50)
    w2 = rl.world(w)
    np.testing.assert_array_equal(w2.values >= 0, (w.values >= 0)[rl.sources][:, rl.items])
    np.testing.assert_array_equal(w2.values == 0, (w.values == 0)[rl.sources][:, rl.items])
    assert len(w2.copies) == len(w.copies)
    m = CopyModel()
    c = square_scores(w.values, w.accuracy, data.oracle_claim_probs(w.values), m)
    c2 = square_scores(w2.values, w2.accuracy, data.oracle_claim_probs(w2.values), m)
    torch.testing.assert_close(c2, c[rl.sources][:, rl.sources], rtol=0, atol=1e-9)
    # the vote is a renumbering too
    v1 = data.truth_table(w.values, w.accuracy, 50, "vote")
    v2 = data.truth_table(w2.values, w2.accuracy, 50, "vote")
    p1 = data.claim_probs(w.values, v1)[rl.sources][:, rl.items]
    np.testing.assert_allclose(data.claim_probs(w2.values, v2), p1, rtol=1e-6)


def test_relabel_differs_by_seed_and_repeats_within_one():
    a, b, c = (data.relabel(s, 50, 80, 50) for s in (1, 1, 2))
    np.testing.assert_array_equal(a.sources, b.sources)
    assert not np.array_equal(a.sources, c.sources)
