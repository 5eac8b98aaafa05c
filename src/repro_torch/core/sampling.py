"""Sampling strategies (§VI-A, §VI-E), host numpy.

BYITEM (SAMPLE1)   — uniform random item columns at a fixed rate.
BYCELL (SAMPLE2)   — add random items until the fraction of non-empty cells
                     reaches a target.
SCALESAMPLE        — random items at a rate, but guarantee at least N=4
                     sampled items per source when possible; this is what
                     keeps copy-detection F-measure high on long-tail data
                     (Table IX).

The same ``np.random.default_rng`` calls as the JAX package's samplers, so
one seed gives the same item indices in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import ClaimsDataset


def sample_by_item(ds: ClaimsDataset, rate: float, seed: int = 0) -> np.ndarray:
    """BYITEM (SAMPLE1): uniform random item columns at a fixed rate.

    Args:
      ds: the (S, D) claims dataset.
      rate: fraction of the D item columns to keep (at least 1 is kept).
      seed: RNG seed — the sample is a pure function of (ds shape, rate,
        seed), so detection runs are replayable (property-tested).

    Returns sorted unique item indices, shape (max(round(rate·D), 1),).
    """
    rng = np.random.default_rng(seed)
    D = ds.n_items
    k = max(int(round(rate * D)), 1)
    return np.sort(rng.choice(D, size=k, replace=False))


def sample_by_cell(ds: ClaimsDataset, cell_fraction: float, seed: int = 0) -> np.ndarray:
    """BYCELL (SAMPLE2): add random items until enough cells are covered.

    Args:
      ds: the (S, D) claims dataset.
      cell_fraction: target fraction of non-empty (source, item) cells the
        sampled columns must cover (≥, by construction).
      seed: RNG seed (deterministic, as for ``sample_by_item``).

    Returns sorted unique item indices (size data-dependent: long-tail data
    needs few dense columns, uniform data ≈ cell_fraction·D).
    """
    rng = np.random.default_rng(seed)
    prov = ds.provided_mask
    total_cells = int(prov.sum())
    target = cell_fraction * total_cells
    perm = rng.permutation(ds.n_items)
    cells_per_item = prov.sum(axis=0)
    csum = np.cumsum(cells_per_item[perm])
    k = int(np.searchsorted(csum, target)) + 1
    return np.sort(perm[:k])


def scale_sample(
    ds: ClaimsDataset, rate: float, min_per_source: int = 4, seed: int = 0
) -> np.ndarray:
    """SCALESAMPLE: ≥ ``min_per_source`` items per source, then fill to rate."""
    rng = np.random.default_rng(seed)
    S, D = ds.values.shape
    prov = ds.provided_mask
    chosen = np.zeros(D, dtype=bool)
    counts = np.zeros(S, dtype=np.int64)

    # pass 1: cover low-coverage sources first
    order = np.argsort(prov.sum(axis=1))
    for s in order:
        need = min_per_source - counts[s]
        if need <= 0:
            continue
        avail = np.nonzero(prov[s] & ~chosen)[0]
        if avail.size == 0:
            continue
        take = rng.choice(avail, size=min(need, avail.size), replace=False)
        chosen[take] = True
        counts += prov[:, take].sum(axis=1)

    # pass 2: random fill to the requested item rate
    target = max(int(round(rate * D)), int(chosen.sum()))
    remaining = np.nonzero(~chosen)[0]
    extra = target - int(chosen.sum())
    if extra > 0 and remaining.size:
        take = rng.choice(remaining, size=min(extra, remaining.size), replace=False)
        chosen[take] = True
    return np.nonzero(chosen)[0]


__all__ = ["sample_by_cell", "sample_by_item", "scale_sample"]
