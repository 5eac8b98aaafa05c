"""The INDEX algorithm (§III), entry-sequential — the exact reference with
the paper's computation accounting (Ex. 3.6: 26 pairs, 51 shared values,
154 computations on the motivating example). NumPy on the host; the oracle
the tiled engine's decisions are held against."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.index import InvertedIndex, build_index
from repro_torch.core.scoring import (
    decide_copying_np,
    posterior_independence_np,
    score_same_np,
)
from repro_torch.core.types import ClaimsDataset, CopyConfig, DetectionResult
from repro_torch.utils.counters import ComputeCounter


def index_detect_exact(
    ds: ClaimsDataset,
    p_claim: np.ndarray,
    cfg: CopyConfig,
    index: InvertedIndex | None = None,
    device=None,
) -> DetectionResult:
    """Algorithm INDEX, steps 1–3 (§III), entry-sequential.

    ``device`` is where a missing index computes its ``l_counts``.
    """
    t0 = time.perf_counter()
    idx = index if index is not None else build_index(ds, p_claim, cfg,
                                                      device=device)
    S = ds.n_sources
    acc = ds.accuracy.astype(np.float64)

    c_same = np.zeros((S, S), dtype=np.float64)
    n_counts = np.zeros((S, S), dtype=np.int32)
    considered = np.zeros((S, S), dtype=bool)
    values_examined = 0

    # Scan non-Ē entries first, then Ē entries: for a fresh index this IS
    # the physical 0..E−1 order (Ē is the score suffix); for an index with
    # an Ē mask the split restores the invariant step 2 relies on — every
    # Ē entry sees the FINAL considered set.
    nonebar = idx.nonebar_mask
    live = idx.live_mask
    scan_order = np.concatenate([np.nonzero(nonebar)[0],
                                 np.nonzero(live & ~nonebar)[0]])
    n_nonebar = int(nonebar.sum())
    for rank, e in enumerate(scan_order):
        srcs = idx.providers(e)
        if len(srcs) < 2:
            continue
        in_ebar = rank >= n_nonebar
        a = acc[srcs]
        # f[i, j] = C→ contribution for (copier=srcs[i], source=srcs[j])
        f = score_same_np(float(idx.entry_p[e]), a[:, None], a[None, :], cfg.s, cfg.n)
        sub = np.ix_(srcs, srcs)
        if not in_ebar:
            # Step 1: every provider pair
            pairmask = np.ones((len(srcs), len(srcs)), dtype=bool)
            np.fill_diagonal(pairmask, False)
            considered[sub] |= pairmask
        else:
            # Step 2: only pairs encountered before
            pairmask = considered[sub].copy()
            np.fill_diagonal(pairmask, False)
        c_same[sub] += np.where(pairmask, f, 0.0)
        n_counts[sub] += pairmask.astype(np.int32)
        values_examined += int(np.triu(pairmask, 1).sum())

    # Step 3: different-value adjustment for considered pairs
    c_fwd = np.where(
        considered, c_same + (idx.l_counts - n_counts) * cfg.ln_1ms, 0.0
    ).astype(np.float32)
    np.fill_diagonal(c_fwd, 0.0)

    pr_ind = posterior_independence_np(c_fwd, c_fwd.T, cfg)
    copying = decide_copying_np(c_fwd, c_fwd.T, cfg)
    # pairs never considered ⇒ no-copying with Pr⊥ > .5 (paper's Ē argument)
    pr_ind = np.where(considered, pr_ind, 1.0).astype(np.float32)
    copying = copying & considered
    np.fill_diagonal(pr_ind, 1.0)
    np.fill_diagonal(copying, False)

    n_pairs = int(np.triu(considered, 1).sum())
    counter = ComputeCounter(
        pairs_considered=n_pairs,
        shared_values_examined=values_examined,
        score_computations=2 * values_examined + 2 * n_pairs,
        index_entries=idx.n_entries,
    )
    return DetectionResult(c_fwd=c_fwd, pr_independent=pr_ind, copying=copying,
                           counter=counter, wall_time_s=time.perf_counter() - t0)


__all__ = ["index_detect_exact"]
