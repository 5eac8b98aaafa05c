"""The port's FAGININPUT baseline (``repro_torch.core.fagin``) against the
JAX package's ``repro.core.fagin`` on the motivating example and on two
synthetic worlds (numpy, from a seed): every per-entry list (its pairs in
order, and its scores), the different-value list and the counter equal.
Scores are float64 numpy in both packages, so the tolerance is float64
round-off (rtol 1e-12); pair orders and counts are exact.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest

from repro.core.fagin import fagin_input as jax_fagin_input
from repro.core.types import ClaimsDataset as JDataset
from repro.core.types import CopyConfig as JConfig
from repro_torch.core import build_index, fagin_input
from repro_torch.core.types import CopyConfig
from repro_torch.data.claims import (
    SyntheticSpec,
    motivating_example,
    motivating_value_probs,
    oracle_claim_probs,
    synthetic_claims,
)

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
JCFG = JConfig(alpha=0.1, s=0.8, n=50.0)
RTOL = 1e-12


def _world(name):
    if name == "motivating":
        ds = motivating_example()
        return ds, motivating_value_probs(ds)
    coverage, seed = name.split("-")
    sc = synthetic_claims(SyntheticSpec(n_sources=48, n_items=200,
                                        coverage=coverage, n_cliques=3,
                                        seed=int(seed)))
    return sc.dataset, oracle_claim_probs(sc)


def _same_lists(got, want):
    (g_lists, g_diff, g_counter, _), (w_lists, w_diff, w_counter, _) = got, want
    assert len(g_lists) == len(w_lists)
    for (gi, gj, gs), (wi, wj, ws) in zip(g_lists, w_lists):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gj, wj)
        np.testing.assert_allclose(gs, ws, rtol=RTOL)
    for g, w in zip(g_diff[:2], w_diff[:2]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(g_diff[2], w_diff[2], rtol=RTOL)
    assert g_counter.as_dict() == w_counter.as_dict()


@pytest.mark.parametrize("world", ["motivating", "book-0", "stock-1"])
def test_fagin_input_equals_jax(world):
    ds, p = _world(world)
    jds = JDataset(values=ds.values, accuracy=ds.accuracy)
    _same_lists(fagin_input(ds, p, CFG, device="cpu"),
                jax_fagin_input(jds, p, JCFG))


def test_fagin_input_takes_a_prebuilt_index():
    ds, p = _world("book-0")
    idx = build_index(ds, p, CFG, device="cpu")
    _same_lists(fagin_input(ds, p, CFG, index=idx),
                fagin_input(ds, p, CFG, device="cpu"))


def test_fagin_input_materializes_every_pair_score():
    ds = motivating_example()
    lists, _, counter, secs = fagin_input(ds, motivating_value_probs(ds), CFG,
                                          device="cpu")
    assert len(lists) == 13
    # Σ_E C(|S̄(E)|, 2) = 53 pair-scores — no pruning possible
    assert counter.shared_values_examined == 53
    assert counter.score_computations == 106
    for _, _, scores in lists:
        assert np.all(np.diff(scores) <= 1e-6)
    assert secs > 0
