"""The exact pair rescore (``kernels.ops.pair_scores``): on a CPU tensor the
plain version, held bit for bit to the batched body the rescore had before
it became a kernel; on a card, the hand-written kernel
(``csrc/pair_rescore.cu``) held to the plain version.

Tolerance on the card: the kernel takes each agreeing item's float32 terms
in the plain version's steps, but sums them in double (a lane's items,
then a butterfly over the warp) with the different-value term as one
product of an integer count, and rounds once to float32, where the plain
version reduces a (pairs, D) float32 block its own way. The two differ by
the float32 sum's rounding, a few ulp of the sum of the terms' magnitudes:
|Δ| ≤ 1e-5 · Σ|terms| a pair.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
import torch

from repro_torch.core import (
    CopyConfig,
    DetectionEngine,
    build_index,
    index_detect_exact,
    rescore_pairs_exact,
)
from repro_torch.core.scoring import _ln_1ms, score_same
from repro_torch.data.claims import (
    SyntheticSpec,
    book_full_spec,
    oracle_claim_probs,
    synthetic_claims,
)
from repro_torch.kernels import ops, ref

CFG = CopyConfig(alpha=0.1, s=0.8, n=50.0)
#: the card's tolerance, in units of a pair's Σ|terms| (module docstring)
REL_SUM = 1e-5


def _before(vals, p, acc, cfg, pairs_i, pairs_j, batch_elements=1 << 25):
    """The rescore's one-direction body before the kernel (the former
    ``core.scoring.pair_scores_subset``), as it was: the yardstick of the
    plain version's bits."""
    D = vals.shape[1]
    out = torch.empty(len(pairs_i), dtype=torch.float32, device=vals.device)
    ln1ms = _ln_1ms(cfg.s, vals.device)
    zero = torch.zeros((), dtype=torch.float32, device=vals.device)
    step = max(1, batch_elements // max(D, 1))
    for b0 in range(0, len(pairs_i), step):
        pi = pairs_i[b0: b0 + step]
        pj = pairs_j[b0: b0 + step]
        vi, vj = vals[pi], vals[pj]                       # (B, D)
        shared = (vi >= 0) & (vj >= 0)
        same = shared & (vi == vj)
        sc = score_same(p[pi], acc[pi][:, None], acc[pj][:, None],
                        cfg.s, cfg.n)
        contrib = torch.where(same, sc, torch.where(shared, ln1ms, zero))
        out[b0: b0 + step] = contrib.sum(dim=-1)
    return out


def _world(name):
    """(vals, p, acc, pi, pj) of a named world, numpy."""
    rng = np.random.default_rng(sum(map(ord, name)))
    S, D, k, n_pairs = dict(
        d7=(12, 7, 0, 40), d13=(16, 13, 0, 60), d64=(20, 64, 0, 80),
        d101=(24, 101, 0, 120), d520=(16, 520, 0, 100),
        all_missing=(10, 37, 0, 30), nothing_shared=(6, 40, 0, 1),
        single=(8, 33, 0, 1), unsorted=(20, 90, 0, 150),
        query_rows=(18, 75, 5, 90))[name]
    rows = S + k
    # few distinct values an item, so that many shared items agree
    vals = rng.integers(0, 3, size=(rows, D)).astype(np.int32)
    vals[rng.random((rows, D)) < 0.35] = -1
    p = rng.uniform(0.01, 0.99, (rows, D)).astype(np.float32)
    acc = rng.uniform(0.35, 0.95, rows).astype(np.float32)
    if name == "all_missing":
        vals[[1, 4, 7]] = -1
    if name == "nothing_shared":
        vals[0, : D // 2], vals[0, D // 2:] = 1, -1
        vals[3, : D // 2], vals[3, D // 2:] = -1, 1
        return vals, p, acc, np.array([0]), np.array([3])
    tri = np.argwhere(np.triu(np.ones((rows, rows), bool), 1))
    pick = np.sort(rng.choice(len(tri), size=min(n_pairs, len(tri)),
                              replace=False))
    pi, pj = tri[pick, 0], tri[pick, 1]                   # row-major
    if name == "query_rows":                              # (query, corpus)
        pi = rng.integers(S, rows, n_pairs)
        pj = rng.integers(0, S, n_pairs)
    if name == "unsorted":
        order = rng.permutation(len(pi))
        pi, pj = pj[order], pi[order]                     # i > j, shuffled
    return vals, p, acc, pi, pj


WORLDS = ["d7", "d13", "d64", "d101", "d520", "all_missing",
          "nothing_shared", "single", "unsorted", "query_rows"]


def _tensors(name, device="cpu"):
    vals, p, acc, pi, pj = _world(name)
    return (torch.as_tensor(vals, device=device),
            torch.as_tensor(p, device=device),
            torch.as_tensor(acc, device=device),
            torch.as_tensor(pi, dtype=torch.int64, device=device),
            torch.as_tensor(pj, dtype=torch.int64, device=device))


def _float64_scores(vals, p, acc, pi, pj, cfg):
    """C→[i, j] of each pair from the definition, in float64, and the sum of
    its terms' magnitudes."""
    out, mag = [], []
    ln1ms = np.log(np.float64(np.float32(1.0 - cfg.s)))
    for i, j in zip(pi, pj):
        shared = (vals[i] >= 0) & (vals[j] >= 0)
        same = shared & (vals[i] == vals[j])
        pp = p[i][same].astype(np.float64)
        a1, a2 = np.float64(acc[i]), np.float64(acc[j])
        ratio = (pp * a2 + (1 - pp) * (1 - a2)) / (
            pp * a1 * a2 + (1 - pp) * (1 - a1) * (1 - a2) / cfg.n)
        f = np.log(1 - cfg.s + cfg.s * ratio)
        n_diff = int(shared.sum() - same.sum())
        out.append(f.sum() + n_diff * ln1ms)
        mag.append(np.abs(f).sum() + n_diff * abs(ln1ms))
    return np.array(out), np.array(mag)


# --------------------------------------------------------------------------
# CPU: the plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_cpu_takes_the_plain_version_bit_for_bit(world):
    vals, p, acc, pi, pj = _tensors(world)
    launches = ops.pair_scores.launches
    c_ij, c_ji = ops.pair_scores(vals, p, acc, pi, pj, s=CFG.s,
                                 n_false=CFG.n)
    assert ops.pair_scores.launches == launches
    assert torch.equal(c_ij, _before(vals, p, acc, CFG, pi, pj))
    assert torch.equal(c_ji, _before(vals, p, acc, CFG, pj, pi))


@pytest.mark.parametrize("world", ["d101", "query_rows"])
def test_cpu_batches_do_not_change_the_bits(world, monkeypatch):
    """Pairs in batches of a few pair-items give the same bits as one batch:
    each pair's sum is its own row's."""
    vals, p, acc, pi, pj = _tensors(world)
    whole = ops.pair_scores(vals, p, acc, pi, pj, s=CFG.s, n_false=CFG.n)
    batch = 3 * vals.shape[1] + 1
    monkeypatch.setattr(ref, "PAIR_BATCH_ELEMENTS", batch)
    got = ops.pair_scores(vals, p, acc, pi, pj, s=CFG.s, n_false=CFG.n)
    for g, w, (a, b) in zip(got, whole, ((pi, pj), (pj, pi))):
        assert torch.equal(g, w)
        assert torch.equal(g, _before(vals, p, acc, CFG, a, b,
                                      batch_elements=batch))


@pytest.mark.parametrize("world", WORLDS)
def test_plain_version_matches_the_definition(world):
    """Against Eqs. 3–6 from the definition in float64: the same items
    shared and agreeing, each direction with its copier's p and accuracy."""
    vals, p, acc, pi, pj = _world(world)
    c_ij, c_ji = ops.pair_scores(*_tensors(world), s=CFG.s, n_false=CFG.n)
    for got, (a, b) in ((c_ij, (pi, pj)), (c_ji, (pj, pi))):
        want, mag = _float64_scores(vals, p, acc, a, b, CFG)
        assert np.all(np.abs(got.numpy() - want) <= 1e-5 * mag + 1e-6)


def test_edge_worlds_score_as_they_should():
    """Rows of all -1 score 0 with every row; a pair sharing nothing 0."""
    vals, p, acc, _, _ = _tensors("all_missing")
    pi = torch.tensor([1, 1, 4, 0], dtype=torch.int64)
    pj = torch.tensor([2, 7, 9, 7], dtype=torch.int64)
    c_ij, c_ji = ops.pair_scores(vals, p, acc, pi, pj, s=CFG.s, n_false=CFG.n)
    assert torch.equal(c_ij, torch.zeros(4)) and torch.equal(c_ji, c_ij)
    c_ij, c_ji = ops.pair_scores(*_tensors("nothing_shared"), s=CFG.s,
                                 n_false=CFG.n)
    assert c_ij.tolist() == [0.0] and c_ji.tolist() == [0.0]
    empty = torch.zeros(0, dtype=torch.int64)
    c_ij, c_ji = ops.pair_scores(vals, p, acc, empty, empty, s=CFG.s,
                                 n_false=CFG.n)
    assert c_ij.shape == c_ji.shape == (0,)


@pytest.mark.parametrize("world", ["d64", "unsorted", "query_rows"])
def test_rescore_pairs_exact_writes_both_directions(world):
    vals, p, acc, pi, pj = _tensors(world)
    rows = vals.shape[0]
    c_fwd = torch.full((rows, rows), 0.25)
    mask = torch.zeros((rows, rows), dtype=torch.bool)
    mask[pi, pj] = mask[pj, pi] = True
    assert rescore_pairs_exact(vals, p, acc, CFG, pi, pj, c_fwd) == len(pi)
    assert torch.equal(c_fwd[pi, pj], _before(vals, p, acc, CFG, pi, pj))
    assert torch.equal(c_fwd[pj, pi], _before(vals, p, acc, CFG, pj, pi))
    assert bool((c_fwd[~mask] == 0.25).all())
    empty = torch.zeros(0, dtype=torch.int64)
    assert rescore_pairs_exact(vals, p, acc, CFG, empty, empty, c_fwd) == 0


def _bad_operands():
    vals, p, acc, pi, pj = _tensors("d13")
    yield "vals int64", (vals.long(), p, acc, pi, pj)
    yield "vals 1-D", (vals.reshape(-1), p, acc, pi, pj)
    yield "p float64", (vals, p.double(), acc, pi, pj)
    yield "p shape", (vals, p[:, :-1].contiguous(), acc, pi, pj)
    yield "acc shape", (vals, p, acc[:-1], pi, pj)
    yield "acc float64", (vals, p, acc.double(), pi, pj)
    yield "pairs int32", (vals, p, acc, pi.int(), pj)
    yield "pairs 2-D", (vals, p, acc, pi[:, None], pj)
    yield "pair lengths", (vals, p, acc, pi, pj[:-1])
    yield "acc device", (vals, p, acc.to("meta"), pi, pj)
    yield "pairs device", (vals, p, acc, pi, pj.to("meta"))
    yield "meta device", tuple(t.to("meta") for t in (vals, p, acc, pi, pj))


def test_strided_operands_score_as_contiguous_ones():
    """Column-major values and p (a column-sampled dataset's) and strided
    pair lists (``torch.nonzero(..., as_tuple=True)``'s) are taken."""
    vals, p, acc, pi, pj = _tensors("d101")
    want = ops.pair_scores(vals, p, acc, pi, pj, s=CFG.s, n_false=CFG.n)
    got = ops.pair_scores(vals.t().contiguous().t(), p.t().contiguous().t(),
                          acc, torch.stack([pi, pj], 1)[:, 0],
                          torch.stack([pi, pj], 1)[:, 1], s=CFG.s,
                          n_false=CFG.n)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", [c for c, _ in _bad_operands()])
def test_wrapper_raises_on_what_it_does_not_take(case):
    args = dict(_bad_operands())[case]
    with pytest.raises(ValueError):
        ops.pair_scores(*args, s=CFG.s, n_false=CFG.n)


def test_cpu_pass_reports_no_rescore_launch():
    """The tiled pass on the CPU rescores through the plain version:
    pairs rescored, no kernel launched, decisions as the exact INDEX."""
    sc = synthetic_claims(SyntheticSpec(
        n_sources=64, n_items=384, coverage="book", n_cliques=4,
        clique_size=3, clique_items=12, seed=0))
    p = oracle_claim_probs(sc)
    eng = DetectionEngine(CFG, mode="bucketed", tile=64, device="cpu")
    res = eng.detect(sc.dataset, p)
    exact = index_detect_exact(sc.dataset, p, CFG, index=build_index(
        sc.dataset, p, CFG, device="cpu"))
    assert eng.last_stats["rescored_pairs"] > 0
    assert eng.last_stats["rescore_launches"] == 0
    np.testing.assert_array_equal(res.copying, exact.copying)


# --------------------------------------------------------------------------
# the card: the kernel
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _term_magnitudes(vals, p, acc, pi, pj, cfg):
    """Σ|terms| a pair of C→[i, j], in float64 on the operands' device."""
    vi, vj = vals[pi], vals[pj]
    shared = (vi >= 0) & (vj >= 0)
    same = shared & (vi == vj)
    sc = score_same(p[pi].double(), acc[pi][:, None].double(),
                    acc[pj][:, None].double(), cfg.s, cfg.n)
    n_diff = (shared & ~same).sum(dim=1).double()
    return (torch.where(same, sc.abs(), 0.0).sum(dim=1)
            + n_diff * abs(float(np.log(np.float32(1.0 - cfg.s)))))


def _assert_kernel_matches_plain(vals, p, acc, pi, pj):
    launches = ops.pair_scores.launches
    got = ops.pair_scores(vals, p, acc, pi, pj, s=CFG.s, n_false=CFG.n)
    torch.cuda.synchronize()
    assert ops.pair_scores.launches == launches + (1 if len(pi) else 0)
    for g, (a, b) in zip(got, ((pi, pj), (pj, pi))):
        want = ref.pair_scores_torch(vals, p, acc, a, b, s=CFG.s,
                                     n_false=CFG.n)
        bound = REL_SUM * _term_magnitudes(vals, p, acc, a, b, CFG)
        gap = (g.double() - want.double()).abs()
        assert bool((gap <= bound).all()), float((gap - bound).max())


@pytest.mark.gpu
@pytest.mark.parametrize("world", WORLDS)
def test_kernel_matches_plain_on_card(cuda_device, world):
    """Both variants: 16-byte loads (D % 4 == 0: d64, d520, ...) and 4-byte
    ones (D = 7, 13, 101, ...)."""
    _assert_kernel_matches_plain(*_tensors(world, cuda_device))


@pytest.mark.gpu
def test_kernel_takes_strided_operands_on_card(cuda_device):
    vals, p, acc, pi, pj = _tensors("d64", cuda_device)
    want = ops.pair_scores(vals, p, acc, pi, pj, s=CFG.s, n_false=CFG.n)
    got = ops.pair_scores(vals.t().contiguous().t(), p.t().contiguous().t(),
                          acc, torch.stack([pi, pj], 1)[:, 0],
                          torch.stack([pi, pj], 1)[:, 1], s=CFG.s,
                          n_false=CFG.n)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_kernel_edge_worlds_on_card(cuda_device):
    vals, p, acc, _, _ = _tensors("all_missing", cuda_device)
    pi = torch.tensor([1, 1, 4, 0], dtype=torch.int64, device=cuda_device)
    pj = torch.tensor([2, 7, 9, 7], dtype=torch.int64, device=cuda_device)
    c_ij, c_ji = ops.pair_scores(vals, p, acc, pi, pj, s=CFG.s, n_false=CFG.n)
    assert c_ij.tolist() == [0.0] * 4 and c_ji.tolist() == [0.0] * 4
    c_ij, c_ji = ops.pair_scores(*_tensors("nothing_shared", cuda_device),
                                 s=CFG.s, n_false=CFG.n)
    assert c_ij.tolist() == [0.0] and c_ji.tolist() == [0.0]


@pytest.fixture(scope="module")
def book_full():
    """Book-full's world (3,182 sources × 20,000 items) and 4,000 pairs,
    row-major as the finalize lists them, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    sc = synthetic_claims(book_full_spec(seed=0))
    ds, p = sc.dataset, oracle_claim_probs(sc)
    rng = np.random.default_rng(7)
    S = ds.n_sources
    i = rng.integers(0, S - 1, 4000)
    j = rng.integers(0, S, 4000)
    keep = i < j
    order = np.lexsort((j[keep], i[keep]))
    dev = torch.device("cuda")
    return (torch.as_tensor(ds.values, device=dev),
            torch.as_tensor(np.asarray(p, np.float32), device=dev),
            torch.as_tensor(ds.accuracy, dtype=torch.float32, device=dev),
            torch.as_tensor(i[keep][order], device=dev),
            torch.as_tensor(j[keep][order], device=dev))


@pytest.mark.gpu
def test_kernel_matches_plain_at_book_full_on_card(book_full):
    _assert_kernel_matches_plain(*book_full)


@pytest.mark.gpu
def test_two_launches_are_bit_equal_on_card(book_full):
    """No atomics: two launches on the same inputs give the same bits."""
    a = ops.pair_scores(*book_full, s=CFG.s, n_false=CFG.n)
    b = ops.pair_scores(*book_full, s=CFG.s, n_false=CFG.n)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_bucketed_pass_on_card_rescores_through_the_kernel(cuda_device):
    """A tiled pass on the card: its near-boundary pairs go through the
    kernel (``rescore_launches``), and it decides as the exact INDEX."""
    sc = synthetic_claims(SyntheticSpec(
        n_sources=96, n_items=480, coverage="book", n_cliques=5,
        clique_size=3, clique_items=12, seed=3))
    p = oracle_claim_probs(sc)
    eng = DetectionEngine(CFG, mode="bucketed", tile=64, device=cuda_device)
    res = eng.detect(sc.dataset, p)
    exact = index_detect_exact(sc.dataset, p, CFG, index=build_index(
        sc.dataset, p, CFG, device="cpu"))
    assert eng.last_stats["rescored_pairs"] > 0
    assert eng.last_stats["rescore_launches"] == 1
    np.testing.assert_array_equal(res.copying, exact.copying)
