"""The port's INCREMENTAL (§V) against the JAX package, on the CPU.

A HYBRID bootstrap and three rounds on perturbed probabilities (the JAX
package's ``_perturb``), each round held against the JAX package's round on
the same inputs: decisions, the pass-1 settled share, the counters and the
per-entry bookkeeping exact; C→ and Ĉ within rtol 2e-5 / atol 1e-4
(ROADMAP C4); Pr(⊥) within 1e-6 (C3). The paper's big-change flip
(Ex. 5.1) and the engine's round lifecycle are checked beside them.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest

from repro.core.incremental import incremental_detect as j_incremental_detect
from repro.core.incremental import make_incremental_state as j_make_state
from repro.core.types import CopyConfig as JCfg
from repro.data import claims as jc
from repro_torch.core import DetectionEngine, build_index
from repro_torch.core.incremental import (
    first_providers,
    incremental_detect,
    make_incremental_state,
)
from repro_torch.core.scoring import pairwise_detect
from repro_torch.core.types import ClaimsDataset, CopyConfig

CFG_J = JCfg(alpha=0.1, s=0.8, n=50.0)
CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
RTOL, ATOL = 2e-5, 1e-4


def _perturb(p_claim, rng, scale):
    noise = rng.normal(0.0, scale, size=p_claim.shape).astype(np.float32)
    return np.clip(p_claim + np.where(p_claim > 0, noise, 0.0), 1e-3, 0.999)


def _world(name):
    if name == "motivating":
        ds = jc.motivating_example()
        return ds, jc.motivating_value_probs(ds), 13, 0.005
    spec = {
        "stock60": dict(n_sources=60, n_items=400, coverage="stock",
                        n_cliques=5, clique_size=3, seed=2),
        "s96": dict(n_sources=96, n_items=480, coverage="book", n_cliques=5,
                    clique_size=3, clique_items=12, seed=3),
    }[name]
    sc = jc.synthetic_claims(jc.SyntheticSpec(**spec))
    return sc.dataset, jc.oracle_claim_probs(sc), 64, 0.01


def _port(ds):
    return ClaimsDataset(values=ds.values.copy(), accuracy=ds.accuracy.copy())


def _assert_result_equal(got, want):
    np.testing.assert_array_equal(got.copying, want.copying)
    np.testing.assert_allclose(got.c_fwd, want.c_fwd, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.pr_independent, want.pr_independent,
                               rtol=0, atol=1e-6)
    assert vars(got.counter) == vars(want.counter)


@pytest.mark.parametrize("world", ["motivating", "stock60", "s96"])
def test_bootstrap_and_rounds_equal_jax(world):
    ds, p, nb, scale = _world(world)
    tds = _port(ds)
    want, jst = j_make_state(ds, p, CFG_J, n_buckets=nb)
    got, st = make_incremental_state(tds, p, CFG, n_buckets=nb, device="cpu")
    _assert_result_equal(got, want)
    for f in ("entry_bucket", "first_provider", "p_old", "score_old",
              "a1_ref", "a2_ref"):
        np.testing.assert_array_equal(getattr(st, f), getattr(jst, f), f)
    for f in ("copying", "considered", "dec_bucket"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), getattr(jst, f))
    rng = np.random.default_rng(1)
    pk = p
    for rnd in range(3):
        pk = _perturb(pk, rng, scale)
        want = j_incremental_detect(ds, pk, CFG_J, jst)
        got = incremental_detect(tds, pk, CFG, st)
        _assert_result_equal(got, want)
        assert st.pass1_settled == jst.pass1_settled, rnd
        np.testing.assert_allclose(st.c_hat.numpy(), jst.c_hat, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(st.err.numpy(), jst.err, rtol=RTOL,
                                   atol=ATOL)
        for f in ("p_old", "score_old", "acc_old"):
            np.testing.assert_array_equal(getattr(st, f), getattr(jst, f), f)


def test_big_change_flips_decision():
    """Ex. 5.1's flip, as the JAX package's test builds it: a pair decided
    copying on 3 shared low-probability values flips to no-copying when
    those values turn out to be likely true (P .02 → .97)."""
    values = -np.ones((6, 5), dtype=np.int32)
    values[0] = [0, 0, 0, 1, 1]
    values[1] = [0, 0, 0, 2, 2]
    values[2] = [0, 1, 1, 1, 2]
    values[3] = [1, 0, 0, 2, 1]
    values[4] = [1, 1, 1, 1, 1]
    values[5] = [0, 1, 0, 2, 2]
    acc = np.array([0.6, 0.6, 0.5, 0.5, 0.5, 0.5], dtype=np.float32)
    ds = ClaimsDataset(values=values, accuracy=acc)
    p_old = np.full(values.shape, 0.3, dtype=np.float32)
    p_old[values == 0] = 0.02
    _, st = make_incremental_state(ds, p_old, CFG, n_buckets=8, device="cpu")
    assert bool(st.copying[0, 1]), "precondition: pair decided copying"
    p_new = p_old.copy()
    p_new[values == 0] = 0.97
    res = incremental_detect(ds, p_new, CFG, st)
    ref = pairwise_detect(ds, p_new, CFG, device="cpu")
    np.testing.assert_array_equal(res.copying,
                                  ref.copying & st.considered.numpy())
    assert not res.copying[0, 1], "decision must flip to no-copying"

    from repro.core.types import ClaimsDataset as JDS
    jds = JDS(values=values.copy(), accuracy=acc.copy())
    _, jst = j_make_state(jds, p_old, CFG_J, n_buckets=8)
    _assert_result_equal(res, j_incremental_detect(jds, p_new, CFG_J, jst))


def test_engine_round_lifecycle():
    """The engine's first incremental detect is the HYBRID bootstrap; later
    ones are rounds on its state; reset() bootstraps afresh."""
    ds, p, nb, scale = _world("stock60")
    tds = _port(ds)
    eng = DetectionEngine(CFG, mode="incremental", n_buckets=nb, device="cpu")
    assert eng.incremental_state is None
    boot = eng.detect(tds, p)
    hyb = DetectionEngine(CFG, mode="hybrid", n_buckets=nb,
                          device="cpu").detect(tds, p)
    np.testing.assert_array_equal(boot.copying, hyb.copying)
    st = eng.incremental_state
    assert st is not None and eng.last_stats["rescored_pairs"] >= 0
    p2 = _perturb(p, np.random.default_rng(3), scale)
    rnd = eng.detect(tds, p2)
    assert eng.incremental_state is st
    assert 0.0 <= eng.last_stats["pass1_settled"] == st.pass1_settled <= 1.0
    assert rnd.counter.pairs_considered == eng.last_stats["candidates"]
    eng.reset()
    assert eng.incremental_state is None
    np.testing.assert_array_equal(eng.detect(tds, p).copying, boot.copying)


def test_first_providers_equal_numpy_argmax():
    ds, p, _, _ = _world("s96")
    idx = build_index(_port(ds), p, CFG, chunk_entries=40, device="cpu")
    want = np.concatenate([ch.V.argmax(axis=0)
                           for ch in idx.store.iter_chunks()])
    np.testing.assert_array_equal(first_providers(idx.store), want)


def test_bootstrap_on_a_committed_index_equals_jax():
    """The bootstrap iterates a committed index's base + delta chunks as
    they lie (no re-gather), in both packages alike."""
    import repro.core as jcore
    from repro.core.types import ClaimsDataset as JDS
    from test_torch_mutation import _Twin, _rows, _world as _mworld

    twin = _Twin((jcore, None, JDS), *_mworld(3), 16, capacity=60)
    twin.commit(*_rows(4, 6, 160), compact=False)
    assert twin.t.store.n_delta_chunks > 0
    ds, p = twin.claims()
    jds = JDS(values=ds.values.copy(), accuracy=ds.accuracy.copy())
    want, jst = j_make_state(jds, p, CFG_J, n_buckets=16, index=twin.j)
    got, st = make_incremental_state(ds, p, CFG, n_buckets=16,
                                     index=twin.t, device="cpu")
    _assert_result_equal(got, want)
    np.testing.assert_array_equal(st.dec_bucket.numpy(), jst.dec_bucket)
    np.testing.assert_array_equal(st.first_provider, jst.first_provider)
    p2 = _perturb(p, np.random.default_rng(5), 0.01)
    _assert_result_equal(incremental_detect(ds, p2, CFG, st),
                         j_incremental_detect(jds, p2, CFG_J, jst))
    assert st.pass1_settled == jst.pass1_settled
