"""The plain reference: the paper's motivating example and a brute-force
loop over Eqs. 2-8."""
import math

import numpy as np
import pytest
import torch

from cdbench import data
from cdbench.reference import (
    CopyModel,
    decide,
    pair_scores_dense,
    square_scores,
)


def brute(values, acc, p, m: CopyModel):
    S, D = values.shape
    c = np.zeros((S, S))
    for i in range(S):
        for j in range(S):
            if i == j:
                continue
            for d in range(D):
                vi, vj = values[i, d], values[j, d]
                if vi < 0 or vj < 0:
                    continue
                if vi != vj:
                    c[i, j] += math.log(1 - m.s)
                    continue
                P, a1, a2 = float(p[i, d]), float(acc[i]), float(acc[j])
                phi = P * a2 + (1 - P) * (1 - a2)
                ind = P * a1 * a2 + (1 - P) * (1 - a1) * (1 - a2) / m.n
                c[i, j] += math.log(1 - m.s + m.s * phi / ind)
    return c


def test_motivating_example_finds_the_papers_copiers():
    from repro_torch.data.claims import (
        GROUND_TRUTH_COPIES,
        motivating_example,
        motivating_value_probs,
    )
    ds = motivating_example()
    p = motivating_value_probs(ds)
    m = CopyModel()
    c = square_scores(ds.values, ds.accuracy, p, m)
    dec = decide(c, c.T, m).numpy()
    np.fill_diagonal(dec, False)
    found = {(int(i), int(j)) for i, j in zip(*np.nonzero(np.triu(dec, 1)))}
    assert found == GROUND_TRUTH_COPIES


@pytest.fixture(scope="module")
def world():
    w = data.synthetic_claims(data.SyntheticSpec(n_sources=24, n_items=60,
                                                 n_cliques=3, seed=4))
    p = data.oracle_claim_probs(w.values)
    p = np.where(w.values >= 0, p + 0.01 * (w.values % 3), 0).astype(np.float32)
    return w, p


def test_square_scores_equal_the_brute_force_loop(world):
    w, p = world
    m = CopyModel()
    want = brute(w.values, w.accuracy, p, m)
    got = square_scores(w.values, w.accuracy, p, m).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_dense_rows_equal_the_brute_force_loop(world):
    w, p = world
    m = CopyModel()
    want = brute(w.values, w.accuracy, p, m)
    rows = [3, 11]
    fwd, bwd = pair_scores_dense(w.values[rows], p[rows], w.accuracy[rows],
                                 w.values, p, w.accuracy, m)
    fwd, bwd = fwd.numpy(), bwd.numpy()
    for k, r in enumerate(rows):
        fwd[k, r] = bwd[k, r] = 0.0
    np.testing.assert_allclose(fwd, want[rows], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(bwd, want[:, rows].T, rtol=1e-12, atol=1e-12)


def test_bfloat16_scores_differ_from_float64(world):
    w, p = world
    m = CopyModel()
    exact = square_scores(w.values, w.accuracy, p, m)
    low = square_scores(w.values, w.accuracy, p, m, dtype=torch.bfloat16)
    assert low.dtype == torch.float32
    gap = ((low.double() - exact).abs() / exact.abs().clamp(min=1)).max()
    assert gap > 1e-3
