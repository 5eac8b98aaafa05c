"""The port's iterative truth finding (``repro_torch.core.truthfind``)
against the JAX package's ``repro.core.truthfind``.

- ``build_value_groups`` equals JAX's field by field.
- The sparse co-provider round ``vote_round`` equals the dense plain
  version ``vote_round_dense`` and JAX's jitted ``_vote_round`` on the same
  inputs, on a world with ranks that tie in float32 and an item with no
  values.
- ``truth_finding`` equals JAX's for ``pairwise``, ``index_exact``,
  ``bound``, ``bound+``, ``hybrid`` and ``incremental`` on the motivating
  example and on a book-coverage world that runs all 6 rounds: equal
  rounds, equal decisions in every round, accuracies and ``p_entry``
  within rtol 2e-5 / atol 1e-4 (ROADMAP C3–C4: Pr(⊥) of the port's oracle
  modes is float64, XLA's and PyTorch's float32 sums differ in order).
- ``index`` (the bucketed engine) is held against the port's own
  ``index_exact`` run, since JAX's raises on the installed jax (ROADMAP
  C1): equal rounds and decisions in every round and equal
  ``fusion_accuracy``, accuracies and ``p_entry`` within atol 1e-3 (the
  bucketed scores of pairs outside the rescore margin are bounded
  approximations, so their Pr(⊥) move while their decisions do not). Copy-
  aware fusion beats naive voting, the port's twin of the JAX test that C1
  fails.
- Table II: the port's twins of the JAX package's checks on the motivating
  example.
- ``fusion_accuracy`` equals JAX's, ties and NaN included.
- The ``gpu`` case: truth finding on the card against the CPU.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.engine as jengine
import repro.core.truthfind as jtf
import repro_torch.core.engine as tengine
from repro.core.types import ClaimsDataset as JDataset
from repro.core.types import CopyConfig as JConfig
from repro_torch.core import truth_finding
from repro_torch.core.truthfind import (
    build_value_groups,
    claim_pairs,
    fusion_accuracy,
    vote_round,
    vote_round_dense,
)
from repro_torch.core.types import ClaimsDataset, CopyConfig
from repro_torch.data.claims import (
    GROUND_TRUTH_COPIES,
    SyntheticSpec,
    motivating_example,
    synthetic_claims,
)

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0, c=0.8)
JCFG = JConfig(alpha=0.1, s=0.8, n=50.0, c=0.8)
RTOL, ATOL = 2e-5, 1e-4          # ROADMAP C4
INDEX_ATOL = 1e-3                # bucketed vs exact INDEX (see the docstring)
DETECTORS = ("pairwise", "index_exact", "bound", "bound+", "hybrid",
             "incremental")
# all 6 rounds run with every detector (the stock worlds stop after 1)
BOOK = SyntheticSpec(n_sources=60, n_items=400, coverage="book", n_cliques=4,
                     clique_size=3, clique_items=14, seed=0)


def _world(name):
    """(port dataset, JAX dataset, true values) from the same numpy arrays."""
    if name == "motivating":
        ds, truth = motivating_example(), None
    else:
        sc = synthetic_claims(BOOK)
        ds, truth = sc.dataset, sc.true_values
    return ds, JDataset(values=ds.values.copy(), accuracy=ds.accuracy.copy()), truth


def _record_rounds(monkeypatch, cls):
    """Every ``detect`` result of ``cls``'s engines, in call order."""
    seen = []
    orig = cls.detect

    def detect(self, *a, **kw):
        res = orig(self, *a, **kw)
        seen.append(res.copying.copy())
        return res
    monkeypatch.setattr(cls, "detect", detect)
    return seen


def _near_tie_world(seed=0):
    """S = 8 sources over 30 items (item 7 has no values), with accuracies
    a0 − s/S, so that acc·S + s of several sources round to the same
    float32 rank and neither of such a pair discounts the other."""
    rng = np.random.default_rng(seed)
    S, D = 8, 30
    values = rng.integers(-1, 3, size=(S, D)).astype(np.int32)
    values[:, 7] = -1
    acc = (np.float32(0.93) - np.arange(S, dtype=np.float32) / S).astype(np.float32)
    pr = rng.uniform(0.0, 1.0, size=(S, S)).astype(np.float32)
    pr = ((pr + pr.T) / 2).astype(np.float32)
    np.fill_diagonal(pr, 0.0)
    return ClaimsDataset(values=values, accuracy=acc), acc, pr


# -- value groups and the vote round ----------------------------------------

@pytest.mark.parametrize("world", ["motivating", "book", "near_tie"])
def test_value_groups_equal_jax(world):
    if world == "near_tie":
        ds = _near_tie_world()[0]
        jds = JDataset(values=ds.values, accuracy=ds.accuracy)
    else:
        ds, jds, _ = _world(world)
    j, t = jtf.build_value_groups(jds), build_value_groups(ds)
    for f in ("V_all", "entry_item", "claim_entry", "n_values_per_item"):
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


def test_sparse_round_equals_dense_and_jax_with_rank_ties():
    ds, acc, pr = _near_tie_world()
    S = ds.n_sources
    rank = acc * S + np.arange(S, dtype=np.float32)
    assert len(np.unique(rank)) < S, "the world must hold tied float32 ranks"
    # JAX's rank order, as its round builds it, against the port's
    j_rank = jnp.asarray(acc) * S + jnp.arange(S, dtype=jnp.float32)
    j_h = np.asarray(j_rank[None, :] > j_rank[:, None])
    t_rank = torch.from_numpy(acc) * S + torch.arange(S, dtype=torch.float32)
    np.testing.assert_array_equal((t_rank[None, :] > t_rank[:, None]).numpy(),
                                  j_h)

    groups = build_value_groups(ds)
    assert groups.n_values_per_item[7] == 0
    jg = jtf.build_value_groups(JDataset(values=ds.values, accuracy=acc))
    j_p, j_acc = jtf._vote_round(
        jnp.asarray(jg.V_all), jnp.asarray(jg.entry_item), jnp.asarray(acc),
        jnp.asarray(pr), CFG.n, CFG.c, ds.n_items,
        jnp.asarray(jg.n_values_per_item))
    acc_t, pr_t = torch.from_numpy(acc), torch.from_numpy(pr)
    # chunks of ≤ 16 pairs: many chunks, claims of one entry split across them
    cp = claim_pairs(groups, "cpu", pair_chunk=16)
    assert len(cp.chunks) > 4
    sp_p, sp_acc = vote_round(cp, acc_t, pr_t, CFG.n, CFG.c)
    de_p, de_acc = vote_round_dense(groups, acc_t, pr_t, CFG.n, CFG.c, block=7)
    for got in (sp_p, de_p):
        np.testing.assert_allclose(got.numpy(), np.asarray(j_p), RTOL, ATOL)
    for got in (sp_acc, de_acc):
        np.testing.assert_allclose(got.numpy(), np.asarray(j_acc), RTOL, ATOL)
    np.testing.assert_allclose(sp_p.numpy(), de_p.numpy(), RTOL, ATOL)
    np.testing.assert_allclose(sp_acc.numpy(), de_acc.numpy(), RTOL, ATOL)
    # one chunk gives the same sums as many
    one_p, one_acc = vote_round(claim_pairs(groups, "cpu"), acc_t, pr_t,
                                CFG.n, CFG.c)
    np.testing.assert_allclose(one_p.numpy(), sp_p.numpy(), RTOL, ATOL)
    np.testing.assert_allclose(one_acc.numpy(), sp_acc.numpy(), RTOL, ATOL)


# -- truth finding against the JAX package ------------------------------------

@pytest.mark.parametrize("detector", DETECTORS)
@pytest.mark.parametrize("world", ["motivating", "book"])
def test_truth_finding_equals_jax(monkeypatch, world, detector):
    ds, jds, _ = _world(world)
    j_rounds = _record_rounds(monkeypatch, jengine.DetectionEngine)
    t_rounds = _record_rounds(monkeypatch, tengine.DetectionEngine)
    j = jtf.truth_finding(jds, JCFG, detector=detector, max_rounds=6,
                          track_history=True)
    t = truth_finding(ds, CFG, detector=detector, max_rounds=6,
                      track_history=True, device="cpu")
    assert t.rounds == j.rounds
    if world == "book":
        assert t.rounds == 6
    assert len(t_rounds) == len(j_rounds) == t.rounds
    for r, (a, b) in enumerate(zip(t_rounds, j_rounds)):
        np.testing.assert_array_equal(a, b, err_msg=f"round {r + 1}")
    for a, b in zip(t.accuracy_history, j.accuracy_history):
        np.testing.assert_allclose(a, b, RTOL, ATOL)
    for a, b in zip(t.p_history, j.p_history):
        np.testing.assert_allclose(a, b, RTOL, ATOL)
    np.testing.assert_allclose(t.accuracy, j.accuracy, RTOL, ATOL)
    np.testing.assert_allclose(t.p_entry, j.p_entry, RTOL, ATOL)
    np.testing.assert_allclose(t.p_claim, j.p_claim, RTOL, ATOL)
    assert t.p_claim.dtype == np.float32
    assert t.detection.copying_pairs() == j.detection.copying_pairs()
    assert [c.total for c in t.counters] == [c.total for c in j.counters]


@pytest.mark.parametrize("world", ["motivating", "book"])
def test_index_detector_equals_index_exact(monkeypatch, world):
    ds, _, truth = _world(world)
    runs = {}
    for det in ("index", "index_exact"):
        seen = _record_rounds(monkeypatch, tengine.DetectionEngine)
        runs[det] = (truth_finding(ds, CFG, detector=det, max_rounds=6,
                                   track_history=True, device="cpu"), seen)
        monkeypatch.undo()
    (b, b_rounds), (e, e_rounds) = runs["index"], runs["index_exact"]
    assert b.rounds == e.rounds
    assert len(b_rounds) == len(e_rounds) == b.rounds
    for r, (x, y) in enumerate(zip(b_rounds, e_rounds)):
        np.testing.assert_array_equal(x, y, err_msg=f"round {r + 1}")
    np.testing.assert_allclose(b.accuracy, e.accuracy, 0, INDEX_ATOL)
    np.testing.assert_allclose(b.p_entry, e.p_entry, 0, INDEX_ATOL)
    if truth is not None:
        assert (fusion_accuracy(b, ds, truth)
                == fusion_accuracy(e, ds, truth))


def test_fusion_beats_naive_voting_on_synthetic():
    """Copy-aware fusion recovers truth at least as well as copy-blind
    fusion when copier cliques outvote honest sources (the JAX package's
    test at ``tests/test_truthfind.py``, which fails there on C1)."""
    spec = SyntheticSpec(n_sources=40, n_items=300, coverage="stock",
                         n_cliques=6, clique_size=4, acc_low=0.25,
                         acc_high=0.9, seed=5)
    sc = synthetic_claims(spec)
    res_copy = truth_finding(sc.dataset, CFG, detector="index", max_rounds=6,
                             device="cpu")
    acc_with = fusion_accuracy(res_copy, sc.dataset, sc.true_values)
    blind = CopyConfig(alpha=1e-9, s=CFG.s, n=CFG.n, c=0.0)
    res_blind = truth_finding(sc.dataset, blind, detector="index",
                              max_rounds=6, device="cpu")
    acc_without = fusion_accuracy(res_blind, sc.dataset, sc.true_values)
    assert acc_with >= acc_without
    assert acc_with > 0.8


# -- Table II on the motivating example ---------------------------------------

@pytest.fixture(scope="module")
def fused():
    ds = motivating_example()
    return ds, truth_finding(ds, CFG, detector="pairwise", max_rounds=8,
                             track_history=True, device="cpu")


def entry_prob(ds, res, item, vname):
    d, vid = {v: k for k, v in ds.value_names.items()}[f"{item}.{vname}"]
    s = int(np.nonzero(ds.values[:, d] == vid)[0][0])
    return float(res.p_entry[res.groups.claim_entry[s, d]])


def test_converges_quickly(fused):
    _, res = fused
    assert res.rounds <= 8


def test_albany_flip(fused):
    """Naive voting first prefers NY.NewYork (3 copier votes); copy
    detection flips the truth to NY.Albany (Table II-b)."""
    ds, res = fused
    assert entry_prob(ds, res, "NY", "Albany") > 0.6
    assert entry_prob(ds, res, "NY", "NewYork") < 0.3


def test_converged_value_probabilities(fused):
    ds, res = fused
    assert entry_prob(ds, res, "NJ", "Trenton") > 0.85
    assert entry_prob(ds, res, "NJ", "Atlantic") < 0.15
    assert entry_prob(ds, res, "TX", "Austin") > 0.85
    assert entry_prob(ds, res, "AZ", "Phoenix") > 0.85


def test_converged_accuracies_match_table_ii(fused):
    _, res = fused
    acc = res.accuracy
    # Table II-a round 5: S0=.99 S1=.99 S2=.2 S3=.2 S4=.4
    assert acc[0] > 0.9 and acc[1] > 0.9
    assert acc[2] < 0.4 and acc[3] < 0.4
    assert 0.2 < acc[4] < 0.65
    assert acc[0] - acc[2] > 0.4


def test_copying_detected_after_convergence(fused):
    _, res = fused
    assert GROUND_TRUTH_COPIES <= res.detection.copying_pairs()


def test_value_groups_structure():
    ds = motivating_example()
    g = build_value_groups(ds)
    # 13 shared + 3 singleton values = 16 distinct claims
    assert g.V_all.shape[1] == 16
    assert (g.claim_entry[ds.values >= 0] >= 0).all()
    assert (g.claim_entry[ds.values < 0] == -1).all()


# -- fusion accuracy -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fusion_accuracy_equals_jax_with_ties(seed):
    """Probabilities on a 0.1 grid tie often; NaN entries never win, and an
    item whose entries are all NaN counts as having none."""
    rng = np.random.default_rng(seed)
    values = rng.integers(-1, 4, size=(12, 40)).astype(np.int32)
    values[:, 3] = -1
    ds = ClaimsDataset(values=values, accuracy=np.full(12, 0.8, np.float32))
    t_groups = build_value_groups(ds)
    j_groups = jtf.build_value_groups(JDataset(values=values,
                                               accuracy=ds.accuracy))
    p = np.round(rng.uniform(0, 1, len(t_groups.entry_item)), 1)
    p = p.astype(np.float32)
    p[rng.random(len(p)) < 0.1] = np.nan
    p[t_groups.entry_item == 5] = np.nan
    truth = rng.integers(0, 4, size=40).astype(np.int32)
    got = fusion_accuracy(types.SimpleNamespace(p_entry=p, groups=t_groups),
                          ds, truth)
    want = jtf.fusion_accuracy(types.SimpleNamespace(p_entry=p,
                                                     groups=j_groups),
                               ds, truth)
    assert got == want


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("detector", ["index", "hybrid", "incremental"])
def test_truth_finding_on_card_equals_cpu(cuda_device, detector):
    """The same rounds and decisions on the card as on the CPU; accuracies
    and ``p_entry`` within the C4 bar, as float32 sums in another order."""
    ds, _, truth = _world("book")
    card = truth_finding(ds, CFG, detector=detector, max_rounds=6,
                         device=cuda_device)
    cpu = truth_finding(ds, CFG, detector=detector, max_rounds=6,
                        device="cpu")
    assert card.rounds == cpu.rounds
    np.testing.assert_array_equal(card.detection.copying,
                                  cpu.detection.copying)
    np.testing.assert_allclose(card.accuracy, cpu.accuracy, RTOL, ATOL)
    np.testing.assert_allclose(card.p_entry, cpu.p_entry, RTOL, ATOL)
    assert (fusion_accuracy(card, ds, truth)
            == fusion_accuracy(cpu, ds, truth))


# -- the example twins at a tiny size -------------------------------------------

def test_quickstart_example_runs_on_cpu(capsys):
    from repro_torch.examples import quickstart
    fus = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    six = ("[('S2', 'S3'), ('S2', 'S4'), ('S3', 'S4'), ('S6', 'S7'), "
           "('S6', 'S8'), ('S7', 'S8')]")
    assert out.count(f"copying={six}") == 4     # every engine mode agrees
    assert "INDEX(exact)" in out and "computations=154" in out
    assert GROUND_TRUTH_COPIES <= fus.detection.copying_pairs()


def test_truth_finding_e2e_example_runs_on_cpu(capsys):
    from repro_torch.examples import truth_finding_e2e
    results = truth_finding_e2e.main(["--sources", "40", "--items", "200",
                                      "--rounds", "3", "--device", "cpu"])
    assert set(results) == {"pairwise", "index", "hybrid", "incremental"}
    for _, _, acc, rec in results.values():
        assert 0.0 <= acc <= 1.0 and 0.0 <= rec <= 1.0
    assert "copy-detection time" in capsys.readouterr().out
