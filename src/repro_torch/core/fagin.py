"""FAGININPUT baseline (§II-B, Table X).

The port of the JAX package's ``core/fagin.py``. The paper explored Fagin's
NRA top-k algorithm: maintain, per index entry, a list of (pair,
contribution score) sorted by decreasing score, plus one list of
accumulated different-value scores. NRA then merges the lists. The paper's
finding — which the benchmarks reproduce — is that merely *generating the
input lists* (a score for every pair sharing every entry, plus the sort)
already costs more than HYBRID, because it cannot prune: every (pair,
shared value) score must be materialized. Host numpy, as in the JAX
package; only the index's ``l_counts`` product runs on ``device``.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.index import InvertedIndex, build_index
from repro_torch.core.scoring import score_same_np
from repro_torch.core.types import ClaimsDataset, CopyConfig
from repro_torch.utils.counters import ComputeCounter


def fagin_input(
    ds: ClaimsDataset,
    p_claim: np.ndarray,
    cfg: CopyConfig,
    index: InvertedIndex | None = None,
    device=None,
):
    """Generate NRA input lists. Returns (per-entry lists, diff list, counter,
    wall seconds). ``device`` (``None`` → the card) builds the index's
    ``l_counts`` when no ``index`` is given."""
    t0 = time.perf_counter()
    idx = index if index is not None else build_index(ds, p_claim, cfg,
                                                      device=device)
    acc = ds.accuracy.astype(np.float64)
    S = ds.n_sources

    entry_lists = []
    n_scores = 0
    for e in range(idx.n_entries):
        srcs = idx.providers(e)
        a = acc[srcs]
        f = score_same_np(float(idx.entry_p[e]), a[:, None], a[None, :], cfg.s, cfg.n)
        ii, jj = np.triu_indices(len(srcs), 1)
        scores = np.maximum(f[ii, jj], f[jj, ii])  # pair's max-direction score
        order = np.argsort(-scores)
        entry_lists.append((srcs[ii][order], srcs[jj][order], scores[order]))
        n_scores += 2 * len(ii)

    # different-value list: (l − n)·ln(1−s) per pair that has differences
    n_counts = idx.store.cooccurrence()
    diff = (idx.l_counts - n_counts) * cfg.ln_1ms
    iu = np.triu_indices(S, 1)
    mask = (idx.l_counts[iu] - n_counts[iu]) > 0
    order = np.argsort(diff[iu][mask])  # ascending (most negative first)
    diff_list = (iu[0][mask][order], iu[1][mask][order], diff[iu][mask][order])

    counter = ComputeCounter(
        pairs_considered=int((n_counts[iu] > 0).sum()),
        shared_values_examined=n_scores // 2,
        score_computations=n_scores,
    )
    return entry_lists, diff_list, counter, time.perf_counter() - t0


__all__ = ["fagin_input"]
