"""The INDEX algorithm (§III) in two forms.

``index_detect_exact`` — entry-sequential, the exact reference with the
    paper's computation accounting (Ex. 3.6: 26 pairs, 51 shared values,
    154 computations on the motivating example). NumPy on the host; the
    oracle the tiled engine's decisions are held against.

``bucketed_index_detect`` — the compat wrapper over the production path,
    the pair-tiled ``DetectionEngine``. The bucket machinery stays here as
    the full-square oracle: ``pad_buckets`` lays score-ordered buckets out
    as one (K, S, w) tensor, and ``_bucketed_accumulate`` sums
    ``f(A_i, A_j, p̂_k)·(V_k V_kᵀ)`` over the buckets in plain torch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.index import BucketedIndex, InvertedIndex, build_index
from repro_torch.core.scoring import (
    decide_copying_np,
    posterior_independence_np,
    score_same,
    score_same_np,
)
from repro_torch.core.types import ClaimsDataset, CopyConfig, DetectionResult
from repro_torch.utils.counters import ComputeCounter
from repro_torch.utils.device import resolve_device


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


# ---------------------------------------------------------------------------
# Bucketed INDEX: the full-square oracle and the compat entry point
# ---------------------------------------------------------------------------

@dataclass
class PaddedBuckets:
    """Score-ordered index padded to (K, S, w) for fixed-shape bucket scans."""

    v_ksw: torch.Tensor       # (K, S, w) incidence per bucket, zero-padded
    p_hat: torch.Tensor       # (K,) float32
    m_suffix: torch.Tensor    # (K+1,) float32
    ebar_bucket: int
    width: int

    @property
    def n_buckets(self) -> int:
        """K — number of buckets (leading axis of v_ksw)."""
        return self.v_ksw.shape[0]


def pad_buckets(b: BucketedIndex, dtype=None, device=None) -> PaddedBuckets:
    """Lay the buckets out as one zero-padded (K, S, w) tensor on ``device``
    (``None`` → the card). ``dtype`` defaults to int8 on the card, the
    copyscore kernels' incidence type, and to float32 elsewhere.

    This materializes every bucket at once: it is the oracle and legacy
    baseline form only. The engine streams chunks from the store instead.
    """
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.int8 if dev.type == "cuda" else torch.float32
    idx = b.index
    K = b.n_buckets
    w = int(max(np.diff(b.starts))) if K else 1
    v = np.zeros((K, idx.n_sources, w), dtype=np.int8)
    for k in range(K):
        s0, s1 = int(b.starts[k]), int(b.starts[k + 1])
        v[k, :, : s1 - s0] = idx.store.slice_entries(s0, s1)
    return PaddedBuckets(
        v_ksw=torch.from_numpy(v).to(device=dev, dtype=dtype),
        p_hat=torch.as_tensor(b.p_hat, dtype=torch.float32, device=dev),
        m_suffix=torch.as_tensor(b.m_suffix, dtype=torch.float32, device=dev),
        ebar_bucket=b.ebar_bucket, width=w)


def _bucketed_accumulate(v_ksw, p_hat, acc, s, n, ebar_bucket):
    """Sum over buckets: (C_same→, shared counts n, counts outside Ē), each
    (S, S) float32 on ``v_ksw``'s device, in bucket order from zero:

        C_same→[i,j] = Σ_k f→(A_i, A_j, p̂_k) · (V_k V_kᵀ)[i,j]

    with Eq. 6 as ``scoring.score_same`` associates it (the JAX package's
    association). A plain torch oracle of the full square.
    """
    S = v_ksw.shape[1]
    acc = torch.as_tensor(acc, dtype=torch.float32, device=v_ksw.device)
    a1, a2 = acc[:, None], acc[None, :]      # copier rows, source columns
    c_same = torch.zeros((S, S), dtype=torch.float32, device=v_ksw.device)
    n_cnt = torch.zeros_like(c_same)
    n_out = torch.zeros_like(c_same)
    for k in range(v_ksw.shape[0]):
        v_k = v_ksw[k].to(torch.float32)
        count = v_k @ v_k.T
        c_same = c_same + score_same(p_hat[k], a1, a2, s, n) * count
        n_cnt = n_cnt + count
        if k < ebar_bucket:
            n_out = n_out + count
    return c_same, n_cnt, n_out


def bucketed_index_detect(
    ds: ClaimsDataset,
    p_claim: np.ndarray,
    cfg: CopyConfig,
    n_buckets: int = 64,
    rescore_margin: float = 1.0,
    index: InvertedIndex | None = None,
    tile: int = 256,
    device=None,
) -> DetectionResult:
    """Production INDEX — routes through the pair-tiled ``DetectionEngine``
    on ``device`` (``None`` → the card)."""
    from repro_torch.core.engine import DetectionEngine

    eng = DetectionEngine(cfg, mode="bucketed", device=device,
                          n_buckets=n_buckets, rescore_margin=rescore_margin,
                          tile=tile)
    return eng.detect(ds, p_claim, index=index)


__all__ = ["PaddedBuckets", "bucketed_index_detect", "index_detect_exact",
           "pad_buckets"]
