"""Exact Bayesian pair scoring — Eqs. (2)–(8) of the paper.

This module is the *oracle*: the exhaustive PAIRWISE algorithm (§II-B) and
the exact pair rescore, in torch on the caller's device, plus the numpy
twins the host-side index bookkeeping uses.

Conventions:
  C→[i, j] accumulates evidence that source i copies from source j
  ("S1 → S2" in the paper with S1 = i, S2 = j); the same-value contribution
  (Eq. 6) uses Pr(Φ_D(S2)) with S2 = j, the *copied* source. By symmetry of
  the observation, C←[i, j] = C→[j, i]: the backward matrix is the
  transpose, so we only ever materialize C→.

Every expression keeps the JAX package's association, so the two agree to
float32 round-off (the ``log`` implementations differ).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.types import ClaimsDataset, CopyConfig, DetectionResult
from repro_torch.utils.counters import ComputeCounter
from repro_torch.utils.device import resolve_device

# --------------------------------------------------------------------------
# Per-item contribution scores
# --------------------------------------------------------------------------


def pr_phi_source(p, a2):
    """Eq. (4): probability of observing S2's value — P·A2 + (1−P)(1−A2)."""
    return p * a2 + (1.0 - p) * (1.0 - a2)


def pr_independent(p, a1, a2, n):
    """Eq. (3): P·A1·A2 + (1−P)(1−A1)(1−A2)/n."""
    return p * a1 * a2 + (1.0 - p) * (1.0 - a1) * (1.0 - a2) / n


def score_same(p, a_copier, a_source, s, n):
    """Eq. (6) on tensors: C→(D) for a shared value with truth probability p.

    a_copier = A(S1), a_source = A(S2).  Positive, larger for lower p.
    """
    ratio = pr_phi_source(p, a_source) / pr_independent(p, a_copier, a_source, n)
    return torch.log(1.0 - s + s * ratio)


def score_same_np(p, a_copier, a_source, s, n):
    """NumPy twin of ``score_same`` (host-side index/bound bookkeeping)."""
    ratio = (p * a_source + (1 - p) * (1 - a_source)) / (
        p * a_copier * a_source + (1 - p) * (1 - a_copier) * (1 - a_source) / n
    )
    return np.log(1.0 - s + s * ratio)


# Inflation + slack on top of the sampled maximum of the δ sweep below: the
# accuracy sweep is a grid, not an analytic bound — |f(p) − f(p̂)| can peak at
# interior accuracies (≲2e-3/entry beyond the corner max at default s, n),
# and f's monotonicity in p is conditional.
DELTA_INFLATION = 1.5
DELTA_SLACK = 2e-3


def bucket_score_deltas(p_hat, p_lo, p_hi, acc: np.ndarray, cfg: CopyConfig,
                        inflation: float = DELTA_INFLATION,
                        slack: float = DELTA_SLACK) -> np.ndarray:
    """Per-bucket bound δ_k ≳ |f(A_i, A_j, p) − f(A_i, A_j, p̂_k)|.

    For any entry probability p in bucket k's [p_lo, p_hi] range: the
    extremes are swept against a grid of dataset accuracy quantiles, then
    inflated to cover interior maxima the grid misses. The sweep covers both
    role orders, so one δ_k bounds f→ and f← alike. Accumulated Σ δ_k·count
    bounds the p̂ approximation of any pair score, which is what makes the
    tiled decisions provably equal the exact INDEX.
    """
    a_grid = np.unique(np.quantile(acc.astype(np.float64),
                                   [0.0, 0.25, 0.5, 0.75, 1.0]))
    p_hat = np.asarray(p_hat, np.float64)
    delta = np.zeros(len(p_hat), np.float64)
    for a1 in a_grid:
        for a2 in a_grid:
            f_hat = score_same_np(p_hat, a1, a2, cfg.s, cfg.n)
            for pe in (np.asarray(p_lo, np.float64),
                       np.asarray(p_hi, np.float64)):
                f_edge = score_same_np(pe, a1, a2, cfg.s, cfg.n)
                delta = np.maximum(delta, np.abs(f_edge - f_hat))
    return (inflation * delta + slack).astype(np.float32)


def posterior_independence(c_fwd: torch.Tensor, c_bwd: torch.Tensor,
                           cfg: CopyConfig) -> torch.Tensor:
    """Eq. (2) on tensors: Pr(⊥|Φ) = σ(−(ln(α/β) + logaddexp(C→, C←))),
    with z clipped to ±60 in float64 as ``posterior_independence_np`` does."""
    z = np.log(cfg.alpha / cfg.beta) + torch.logaddexp(c_fwd, c_bwd)
    z = z.double().clamp_(-60.0, 60.0)
    return (1.0 / (1.0 + torch.exp(z))).float()


def decide_copying(c_fwd: torch.Tensor, c_bwd: torch.Tensor,
                   cfg: CopyConfig) -> torch.Tensor:
    """copying ⟺ Pr(⊥|Φ) ≤ .5 ⟺ ln(α/β) + logaddexp(C→, C←) ≥ 0."""
    return (np.log(cfg.alpha / cfg.beta) + torch.logaddexp(c_fwd, c_bwd)) >= 0.0


def posterior_independence_np(c_fwd, c_bwd, cfg: CopyConfig):
    """NumPy twin of ``posterior_independence``; clips z to ±60 before the
    sigmoid so float32 never overflows. (S, S) in → (S, S) float32 out."""
    z = np.log(cfg.alpha / cfg.beta) + np.logaddexp(c_fwd, c_bwd)
    out = np.empty_like(z, dtype=np.float64)
    np.clip(z, -60.0, 60.0, out=out)
    return (1.0 / (1.0 + np.exp(out))).astype(np.float32)


def decide_copying_np(c_fwd, c_bwd, cfg: CopyConfig):
    """NumPy twin of ``decide_copying``: bool matrix, True ⟺ Pr(⊥|Φ) ≤ .5."""
    return (np.log(cfg.alpha / cfg.beta) + np.logaddexp(c_fwd, c_bwd)) >= 0.0


def _ln_1ms(s: float, device) -> torch.Tensor:
    """ln(1 − s) as float32, from the float32 value of 1 − s (JAX's order)."""
    return torch.log(torch.tensor(1.0 - s, dtype=torch.float32, device=device))


# --------------------------------------------------------------------------
# PAIRWISE — exhaustive detection (the paper's baseline, §II-B)
# --------------------------------------------------------------------------

def _pairwise_block(vals_i, p_i, acc_i, vals_j, acc_j, s, n):
    """C→ for a (bi, bj) block of source pairs: i copies from j.

    vals_i (bi, D) int32, p_i (bi, D) — truth prob of the value i provides.
    """
    prov_i = (vals_i >= 0)[:, None, :]                    # (bi, 1, D)
    prov_j = (vals_j >= 0)[None, :, :]                    # (1, bj, D)
    shared = prov_i & prov_j
    same = shared & (vals_i[:, None, :] == vals_j[None, :, :])
    p = p_i[:, None, :]                                   # same value ⇒ same p
    a1 = acc_i[:, None, None]
    a2 = acc_j[None, :, None]
    sc = score_same(p, a1, a2, s, n)                      # (bi, bj, D)
    zero = torch.zeros((), dtype=torch.float32, device=sc.device)
    contrib = torch.where(same, sc,
                          torch.where(shared, _ln_1ms(s, sc.device), zero))
    return contrib.sum(dim=-1)


def pairwise_detect(
    ds: ClaimsDataset,
    p_claim: np.ndarray,
    cfg: CopyConfig,
    block: int = 128,
    device=None,
) -> DetectionResult:
    """Exhaustive PAIRWISE copy detection. O(|S|²·|D|) work, on ``device``.

    p_claim[s, d]: probability that the value source s provides on item d is
    true (P(D.v) for v = values[s, d]); ignored where values[s, d] < 0.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    S, D = ds.values.shape
    vals = torch.as_tensor(ds.values, device=dev)
    p = torch.as_tensor(np.asarray(p_claim, np.float32), device=dev)
    acc = torch.as_tensor(ds.accuracy, dtype=torch.float32, device=dev)

    c_fwd = torch.zeros((S, S), dtype=torch.float32, device=dev)
    for i0 in range(0, S, block):
        i1 = min(i0 + block, S)
        for j0 in range(0, S, block):
            j1 = min(j0 + block, S)
            c_fwd[i0:i1, j0:j1] = _pairwise_block(
                vals[i0:i1], p[i0:i1], acc[i0:i1], vals[j0:j1], acc[j0:j1],
                cfg.s, cfg.n)
    c_fwd.fill_diagonal_(0.0)

    pr_ind = posterior_independence(c_fwd, c_fwd.T, cfg)
    copying = decide_copying(c_fwd, c_fwd.T, cfg)
    pr_ind.fill_diagonal_(1.0)
    copying.fill_diagonal_(False)

    # Paper's computation accounting (Ex. 3.6): PAIRWISE examines every shared
    # item of every pair, 2 computations each (C→ and C←), over unordered pairs.
    prov = (vals >= 0).to(torch.float32)
    l_counts = prov @ prov.T                              # exact below 2²⁴ items
    shared_items = int(torch.triu(l_counts, 1).sum(dtype=torch.float64).item())
    counter = ComputeCounter(
        pairs_considered=S * (S - 1) // 2,
        shared_values_examined=shared_items,
        score_computations=2 * shared_items,
    )
    return DetectionResult(
        c_fwd=c_fwd.cpu().numpy(),
        pr_independent=pr_ind.cpu().numpy(),
        copying=copying.cpu().numpy(),
        counter=counter,
        wall_time_s=time.perf_counter() - t0,
    )


__all__ = ["bucket_score_deltas", "decide_copying", "decide_copying_np",
           "pairwise_detect", "posterior_independence",
           "posterior_independence_np", "score_same", "score_same_np"]
