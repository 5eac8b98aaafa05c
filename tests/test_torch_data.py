"""The port's data generators give the JAX package's arrays: the same
``SyntheticSpec`` seed → identical values, accuracies, planted copies and
oracle claim probabilities; the motivating example is identical."""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest

from repro.data import claims as jc
from repro_torch.data import claims as tc


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("coverage,clique_items", [("book", 12), ("book", None),
                                                   ("stock", None)])
def test_synthetic_claims_identical(seed, coverage, clique_items):
    kw = dict(n_sources=60, n_items=150, coverage=coverage, n_cliques=4,
              clique_size=3, clique_items=clique_items, seed=seed)
    j = jc.synthetic_claims(jc.SyntheticSpec(**kw))
    t = tc.synthetic_claims(tc.SyntheticSpec(**kw))
    np.testing.assert_array_equal(t.dataset.values, j.dataset.values)
    np.testing.assert_array_equal(t.dataset.accuracy, j.dataset.accuracy)
    np.testing.assert_array_equal(t.true_values, j.true_values)
    assert t.copies == j.copies
    assert t.copy_edges == j.copy_edges
    np.testing.assert_array_equal(tc.oracle_claim_probs(t),
                                  jc.oracle_claim_probs(j))


def test_motivating_example_identical():
    j = jc.motivating_example()
    t = tc.motivating_example()
    np.testing.assert_array_equal(t.values, j.values)
    np.testing.assert_array_equal(t.accuracy, j.accuracy)
    assert list(t.item_names) == list(j.item_names)
    assert list(t.source_names) == list(j.source_names)
    assert t.value_names == j.value_names
    np.testing.assert_array_equal(tc.motivating_value_probs(t),
                                  jc.motivating_value_probs(j))
    assert tc.GROUND_TRUTH_COPIES == jc.GROUND_TRUTH_COPIES


def test_clique_plan_larger_than_sources_raises():
    with pytest.raises(ValueError):
        tc.synthetic_claims(tc.SyntheticSpec(n_sources=5, n_cliques=2,
                                             clique_size=3))
