"""The port's samplers and its two sampled modes against the JAX package, on
the CPU.

The samplers return the same item indices as the JAX package's for any
seed and rate. ``sampled`` decides like the JAX package's
``index_detect_exact`` on the sampled columns. The JAX engine's tiled path
does not run on the installed jax (ROADMAP C1), so ``sample_verify``'s
sweep and rescore are held against the JAX engine's
``_sample_verify_finalize`` fed the port's sampled result and considered
set: decisions, the candidate set, the sweep's statistics and the counters
exact, C→ within rtol 2e-5 / atol 1e-4 (ROADMAP C4).
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import DetectionEngine as JEngine
from repro.core import sampling as jsampling
from repro.core.bucketed import index_detect_exact as j_exact
from repro.core.types import CopyConfig as JCfg
from repro.data import claims as jc
from repro_torch.core import DetectionEngine, sampling
from repro_torch.core.types import ClaimsDataset, CopyConfig

CFG_J = JCfg(alpha=0.1, s=0.8, n=50.0)
CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
RTOL, ATOL = 2e-5, 1e-4
STRATEGIES = {"scale": "scale_sample", "item": "sample_by_item",
              "cell": "sample_by_cell"}
_CACHE: dict = {}


def _verify_case():
    """The JAX package's sample_verify world, its port and its exact result."""
    if "case" not in _CACHE:
        sc = jc.synthetic_claims(jc.SyntheticSpec(
            n_sources=64, n_items=384, coverage="book", n_cliques=4,
            clique_size=3, clique_items=12, seed=0))
        ds, p = sc.dataset, jc.oracle_claim_probs(sc)
        tds = ClaimsDataset(values=ds.values.copy(),
                            accuracy=ds.accuracy.copy())
        _CACHE["case"] = (ds, tds, p, j_exact(ds, p, CFG_J))
    return _CACHE["case"]


def _prop_dataset():
    if "prop" not in _CACHE:
        _CACHE["prop"] = jc.synthetic_claims(jc.SyntheticSpec(
            n_sources=60, n_items=600, coverage="book", n_cliques=4,
            clique_size=3, clique_items=10, seed=0)).dataset
    return _CACHE["prop"]


@pytest.mark.parametrize("fn", sorted(STRATEGIES.values()))
@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), rate=st.floats(0.05, 0.5))
def test_samplers_equal_jax(fn, seed, rate):
    ds = _prop_dataset()
    tds = ClaimsDataset(values=ds.values, accuracy=ds.accuracy)
    np.testing.assert_array_equal(getattr(sampling, fn)(tds, rate, seed=seed),
                                  getattr(jsampling, fn)(ds, rate, seed=seed))


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_sampled_decides_like_jax_exact_on_the_sample(strategy):
    ds, tds, p, _ = _verify_case()
    eng = DetectionEngine(CFG, mode="sampled", tile=32,
                          sample_strategy=strategy, device="cpu")
    items = eng._sample_items(tds)
    got = eng.detect(tds, p)
    want = j_exact(ds.subset_items(items), p[:, items], CFG_J)
    np.testing.assert_array_equal(got.copying, want.copying)
    assert got.counter.pairs_considered == want.counter.pairs_considered
    assert eng.last_stats["kernel_launches"] == 0         # plain path on cpu


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_sample_verify_finalize_equals_jax(strategy):
    ds, tds, p, _ = _verify_case()
    sampled_eng = DetectionEngine(CFG, mode="sampled", tile=32,
                                  sample_strategy=strategy, device="cpu")
    items = sampled_eng._sample_items(tds)
    sampled = sampled_eng.detect(tds, p)
    considered_s = sampled_eng._last_considered.numpy()

    eng = DetectionEngine(CFG, mode="sample_verify", tile=32,
                          sample_strategy=strategy, device="cpu")
    got = eng.detect(tds, p)
    jeng = JEngine(CFG_J, mode="sample_verify", tile=32,
                   sample_strategy=strategy)
    want = jeng._sample_verify_finalize(ds, p, items, sampled,
                                        sampled_eng.last_stats, considered_s,
                                        time.perf_counter())
    np.testing.assert_array_equal(got.copying, want.copying)
    np.testing.assert_allclose(got.c_fwd, want.c_fwd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(eng._last_considered.numpy(),
                                  jeng._last_considered)
    for k in ("items_sampled", "item_rate", "slack_final", "sweep_rounds",
              "candidate_pairs", "shell_pairs", "sampled_copying_pairs"):
        assert eng.last_stats[k] == jeng.last_stats[k], k
    assert vars(got.counter) == vars(want.counter)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 1000), rate=st.floats(0.1, 0.4),
       strategy=st.sampled_from(list(STRATEGIES)))
def test_sample_verify_equals_exact_on_candidates(seed, rate, strategy):
    """The JAX package's property, on the port: whatever the sample, every
    candidate pair decides as ``index_detect_exact`` and no pair outside the
    candidate set is copying."""
    _, tds, p, exact = _verify_case()
    eng = DetectionEngine(CFG, mode="sample_verify", tile=32, sample_rate=rate,
                          sample_strategy=strategy, sample_seed=seed,
                          device="cpu")
    res = eng.detect(tds, p)
    cand = eng._last_considered.numpy()
    assert (res.copying[cand] == exact.copying[cand]).all()
    assert not res.copying[~cand].any()
