"""The port's BOUND / BOUND+ / HYBRID (§IV) against the JAX package, on the
CPU.

The JAX package's ``bound_detect`` runs on the installed jax (ROADMAP C1
spares it), so the port is held against it directly on the same seeded
worlds: decisions, ``decided``, ``dec_bucket``, the considered set, the
counts and the counters exact; C⁰→, Ĉ→, C→ and the error bound within
rtol 2e-5 / atol 1e-4 (ROADMAP C4); Pr(⊥) within 1e-6 (C3). The paper's
own checks (Ex. 4.2, BOUND+ against BOUND, the quality gates against
PAIRWISE) are ported beside them.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
import torch

from repro.core import DetectionEngine as JEngine
from repro.core.bound import _bound_step as j_bound_step
from repro.core.bound import bound_detect as j_bound_detect
from repro.core.types import CopyConfig as JCfg
from repro.data import claims as jc
from repro_torch.core import DetectionEngine
from repro_torch.core.bound import _bound_step, _new_carry, bound_detect
from repro_torch.core.scoring import pairwise_detect
from repro_torch.core.types import ClaimsDataset, CopyConfig, pair_f_measure

CFG_J = JCfg(alpha=0.1, s=0.8, n=50.0)
CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
RTOL, ATOL = 2e-5, 1e-4
ALGOS = {"bound": (False, 0), "bound+": (True, 0), "hybrid": (True, 16)}


def _world(name):
    if name == "motivating":
        ds = jc.motivating_example()
        return ds, jc.motivating_value_probs(ds), 13
    spec = {
        "s64": dict(n_sources=64, n_items=384, coverage="book", n_cliques=4,
                    clique_size=3, clique_items=12, seed=0),
        "stock70": dict(n_sources=70, n_items=500, coverage="stock",
                        n_cliques=5, clique_size=3, seed=11),
    }[name]
    sc = jc.synthetic_claims(jc.SyntheticSpec(**spec))
    return sc.dataset, jc.oracle_claim_probs(sc), 64


def _port(ds):
    return ClaimsDataset(values=ds.values.copy(), accuracy=ds.accuracy.copy())


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("world", ["motivating", "s64", "stock70"])
def test_bound_modes_equal_jax(world, algo):
    """Result and BoundState of each mode against the JAX package's, and the
    engine's mode against the same function with the JAX engine's defaults
    (HYBRID's l_threshold of 16)."""
    ds, p, nb = _world(world)
    timers, l_thr = ALGOS[algo]
    want, jst = j_bound_detect(ds, p, CFG_J, n_buckets=nb, use_timers=timers,
                               l_threshold=l_thr, return_state=True)
    got, st = bound_detect(_port(ds), p, CFG, n_buckets=nb, use_timers=timers,
                           l_threshold=l_thr, return_state=True, device="cpu")
    np.testing.assert_array_equal(st.decided.numpy(), jst.decided)
    np.testing.assert_array_equal(st.dec_bucket.numpy(), jst.dec_bucket)
    np.testing.assert_array_equal(st.considered.numpy(), jst.considered)
    for f in ("n0", "n_full"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), getattr(jst, f))
    for f in ("c0", "c_hat", "err"):
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(jst, f),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.copying, want.copying)
    np.testing.assert_allclose(got.c_fwd, want.c_fwd, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.pr_independent, want.pr_independent,
                               rtol=0, atol=1e-6)
    assert vars(got.counter) == vars(want.counter)

    eng = DetectionEngine(CFG, mode=algo, n_buckets=nb, device="cpu")
    res = eng.detect(_port(ds), p)
    np.testing.assert_array_equal(res.copying, got.copying)
    assert vars(res.counter) == vars(got.counter)
    assert eng.last_stats["rescored_pairs"] >= 0


def test_engine_hybrid_equals_jax_engine():
    ds, p, nb = _world("motivating")
    res = DetectionEngine(CFG, mode="hybrid", n_buckets=nb,
                          device="cpu").detect(_port(ds), p)
    jres = JEngine(CFG_J, mode="hybrid", n_buckets=nb).detect(ds, p)
    np.testing.assert_array_equal(res.copying, jres.copying)
    np.testing.assert_allclose(res.c_fwd, jres.c_fwd, rtol=RTOL, atol=ATOL)
    assert vars(res.counter) == vars(jres.counter)


def test_carry_keeps_the_jax_dtypes():
    ds, p, nb = _world("s64")
    _, st = bound_detect(_port(ds), p, CFG, n_buckets=nb, use_timers=True,
                         l_threshold=16, return_state=True, device="cpu")
    assert st.decided.dtype == torch.int8
    assert st.dec_bucket.dtype == torch.int32
    assert st.considered.dtype == torch.bool
    for f in ("c0", "n0", "n_full", "c_hat", "err"):
        assert getattr(st, f).dtype == torch.float32, f
    K = int(st.dec_bucket.max())                      # K marks "undecided"
    assert K >= nb and bool((st.dec_bucket[st.decided == 0] == K).all())
    assert set(np.unique(st.decided.numpy())) <= {-1, 0, 1}


def test_bound_decides_s2_s3_early():
    # Ex. 4.2: (S2, S3) concluded copying after 2 shared values (bucket
    # granularity: before the full scan ends)
    ds, p, _ = _world("motivating")
    _, st = bound_detect(_port(ds), p, CFG, n_buckets=13, return_state=True,
                         device="cpu")
    assert int(st.decided[2, 3]) == 1
    assert int(st.dec_bucket[2, 3]) < 13 - 1


def test_bound_plus_fewer_bound_computations():
    ds, p, _ = _world("motivating")
    plain = bound_detect(_port(ds), p, CFG, n_buckets=13, device="cpu")
    plus = bound_detect(_port(ds), p, CFG, n_buckets=13, use_timers=True,
                        device="cpu")
    assert plus.counter.bound_computations <= plain.counter.bound_computations
    np.testing.assert_array_equal(plain.copying, plus.copying)


@pytest.mark.parametrize("coverage", ["book", "stock"])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_synthetic_quality_vs_pairwise(coverage, algo):
    """Table VI's gates, as the JAX package's test sets them: F ≥ .94 for
    BOUND and BOUND+ (long-tail data over-prunes via the h estimate), ≥ .97
    for HYBRID, against PAIRWISE."""
    spec = jc.SyntheticSpec(n_sources=70, n_items=500, coverage=coverage,
                            n_cliques=5, clique_size=3, seed=11)
    sc = jc.synthetic_claims(spec)
    p = jc.oracle_claim_probs(sc)
    ds = _port(sc.dataset)
    ref = pairwise_detect(ds, p, CFG, device="cpu")
    res = DetectionEngine(CFG, mode=algo, device="cpu").detect(ds, p)
    prec, rec, f = pair_f_measure(res.copying_pairs(), ref.copying_pairs())
    assert f >= (0.94 if algo != "hybrid" else 0.97), (prec, rec, f)


def test_counters_are_exact_above_float32_range():
    """ROADMAP C11: the port sums ``shared_values_examined`` and the bound
    checks exactly (float64); the JAX step sums them in float32, which
    rounds past 2²⁴. One bucket where pair (0, 1) shares one value, with
    both counters started at 2²⁴."""
    S, K = 4, 2
    v = np.zeros((S, 8), np.float32)
    v[0, 0] = v[1, 0] = 1.0
    acc = np.full(S, 0.8, np.float32)
    l_counts = np.full((S, S), 20, np.int32)
    d_src = np.full(S, 20.0, np.float32)
    considered = np.ones((S, S), bool)
    np.fill_diagonal(considered, False)
    boundable = considered.copy()
    big = 2.0 ** 24
    zero = np.zeros((S, S), np.float32)
    jcarry = tuple(map(np.asarray, (
        zero, zero, zero, np.zeros(S, np.float32), np.zeros((S, S), np.int8),
        np.full((S, S), K, np.int32), zero, zero, zero,
        np.float32(big), np.float32(big))))
    jout = j_bound_step(jcarry, v, np.float32(0.2), np.float32(1.0),
                        np.float32(0.01), np.int32(0), acc, l_counts, d_src,
                        considered, boundable, s=CFG.s, n=CFG.n,
                        theta_cp=CFG.theta_cp, theta_ind=CFG.theta_ind,
                        ln1ms=CFG.ln_1ms, use_timers=False, K=K)

    carry = _new_carry(S, K, torch.device("cpu"))
    carry.ve += big
    carry.bc += big
    vt = torch.from_numpy(v)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)
    _bound_step(carry, vt @ vt.T, vt.sum(1), f32(0.2), f32(1.0), f32(0.01), 0,
                torch.from_numpy(acc), torch.from_numpy(l_counts).float(),
                torch.from_numpy(d_src), torch.from_numpy(considered),
                torch.from_numpy(boundable), CFG, f32(CFG.n), False, K)
    assert int(carry.ve.item()) == 2 ** 24 + 1
    assert float(jout[9]) == big                     # float32 lost the 1
    checks = 2 * (S * (S - 1) // 2)                  # C^min and C^max, r < c
    assert int(carry.bc.item()) == 2 ** 24 + checks
    assert float(jout[10]) == np.float32(big + checks)
    np.testing.assert_array_equal(carry.decided.numpy(), np.asarray(jout[4]))
    np.testing.assert_array_equal(carry.n0.numpy(), np.asarray(jout[1]))
