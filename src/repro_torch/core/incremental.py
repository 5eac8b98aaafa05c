"""INCREMENTAL detection across fusion rounds (§V).

After round 2 the per-round changes in value probability / source accuracy
are small and rarely flip decisions. The paper's structure, as in the JAX
package:

* classify entries into big / small score changes (|ΔM̂| > ρ, with M̂
  recomputed on the *same* two accuracies as the recorded round — §V-A);
* pass 1: apply exact per-pair deltas for big-change entries (before each
  pair's decision point) and a conservative batched bound Δρ·|Ē↘| for
  small changes; pairs still safely on their side of the threshold keep
  their decision — the paper observes ≥86–99% settle here (Table VIII);
* passes 2–3 are collapsed into one exact rescoring of the flip-candidate
  set (``rescore_pairs_exact``). Pairs containing a source with a big
  accuracy change (|ΔA| > ρ_acc = .2) are rescored unconditionally.

The per-entry bookkeeping (buckets, providers, reference accuracies, old
probabilities and scores) stays in host numpy; the (S, S) state — Ĉ,
decisions, the considered set, decision buckets, the p̂-error bound and the
item counts — lives on the device of the HYBRID bootstrap, where pass 1
runs in float64 and the small-change counts run as exact count products
(``bound.masked_counts``).

The public entry point is ``DetectionEngine(cfg, mode="incremental")``,
which owns the round lifecycle: the first ``detect`` bootstraps the state
here, later calls apply per-round deltas.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.bound import _synced, bound_detect, masked_counts
from repro_torch.core.index import (
    BucketedIndex,
    InvertedIndex,
    bucketize,
    build_index,
    entry_extreme_accuracies,
    prop31_reference_accs,
)
from repro_torch.core.scoring import (
    decide_copying,
    posterior_independence,
    score_same_np,
)
from repro_torch.core.store import _nonzero_2d
from repro_torch.core.types import ClaimsDataset, CopyConfig, DetectionResult
from repro_torch.kernels.ops import pair_scores
from repro_torch.utils.counters import ComputeCounter
from repro_torch.utils.device import resolve_device


@dataclass
class IncrementalState:
    """Bookkeeping carried across rounds (§V preparation step): per-entry
    arrays in host numpy, (S, S) tensors on the bootstrap's device."""

    index: InvertedIndex          # canonical (round-2) entry order — V is fixed
    bucketed: BucketedIndex
    entry_bucket: np.ndarray      # (E,) bucket id per entry
    first_provider: np.ndarray    # (E,) a provider per entry (for p lookup)
    p_old: np.ndarray             # (E,) last-recomputed P(E)
    score_old: np.ndarray         # (E,) M̂ with p_old
    a1_ref: np.ndarray            # (E,) Prop-3.1 accuracies of the reference round
    a2_ref: np.ndarray
    acc_old: np.ndarray           # (S,) accuracies of the reference round
    c_hat: torch.Tensor           # (S,S) float32 Ĉ→ starting scores
    copying: torch.Tensor         # (S,S) bool current decisions
    considered: torch.Tensor      # (S,S) bool
    dec_bucket: torch.Tensor      # (S,S) int32
    l_counts: torch.Tensor        # (S,S) int32 shared-item counts
    err: torch.Tensor             # (S,S) float32 accumulated p̂-error bound on
                                  # c_hat (0 where a round has rescored exactly)
    pass1_settled: float = 1.0


def rescore_pairs_exact(
    vals: torch.Tensor,
    p: torch.Tensor,
    acc: torch.Tensor,
    cfg: CopyConfig,
    pi: torch.Tensor,
    pj: torch.Tensor,
    c_fwd: torch.Tensor,
) -> int:
    """Batched exact rescore of an explicit flip-candidate pair list.

    Shared by every caller that must replace approximate pair scores with
    exact ones: INCREMENTAL's flip candidates, the tiled engine's
    error-bounded near-threshold pairs and SAMPLE-THEN-VERIFY's candidates.

    Args:
      vals, p, acc: the *full* dataset's (S, D) int32 values, (S, D) float32
        per-claim truth probabilities and (S,) float32 accuracies, on the
        device of ``c_fwd``.
      pi, pj: (P,) int64 tensors of source indices — the unordered pairs to
        rescore (each listed once; both orientations are written).
      c_fwd: (S, S) float32 C→ matrix, updated in place at [pi, pj] and
        [pj, pi] with exact Eq. 2–8 scores over all shared items.

    Returns the number of pairs rescored (0 for an empty list).
    """
    if len(pi) == 0:
        return 0
    c_ij, c_ji = pair_scores(vals, p, acc, pi, pj, s=cfg.s, n_false=cfg.n)
    c_fwd[pi, pj] = c_ij
    c_fwd[pj, pi] = c_ji
    return len(pi)


def dataset_tensors(ds: ClaimsDataset, p_claim: np.ndarray, device):
    """(values, p_claim, accuracy) of a dataset on ``device``: the operands
    of ``rescore_pairs_exact``."""
    return (torch.as_tensor(ds.values, device=device),
            torch.as_tensor(np.asarray(p_claim, np.float32), device=device),
            torch.as_tensor(ds.accuracy, dtype=torch.float32, device=device))


def first_providers(store) -> np.ndarray:
    """(E,) int32 — a provider per entry: the first live row of each column,
    which is numpy's ``argmax`` of the 0/1 column (0 for a column without
    providers, as argmax gives), found from the nonzero cells."""
    out = np.zeros(store.n_entries, np.int32)
    none = store.n_rows
    for ch in store.iter_chunks():
        rows, cols = _nonzero_2d(np.ascontiguousarray(ch.V))
        first = np.full(ch.width, none, np.int64)
        np.minimum.at(first, cols, rows)
        first[first == none] = 0
        out[ch.start: ch.start + ch.width] = first
    return out


def make_incremental_state(
    ds: ClaimsDataset, p_claim: np.ndarray, cfg: CopyConfig,
    n_buckets: int = 64,
    chunk_entries: int | None = None,
    chunk_bytes: int | None = None,
    index: InvertedIndex | None = None,
    device=None,
    stats: dict | None = None,
) -> tuple[DetectionResult, IncrementalState]:
    """Run HYBRID from scratch on ``device`` (None → the card) and capture
    the bookkeeping for later rounds (``stats`` as ``bound_detect``'s, plus
    the bookkeeping's host seconds).

    ``chunk_entries`` / ``chunk_bytes`` forward to ``build_index``;
    ``index`` bootstraps from a prebuilt index instead — including a
    committed one (base + delta chunk sequence, Ē as a mask): the per-entry
    arrays are position-indexed, so the delta layout rides along.
    """
    dev = resolve_device(device)
    idx = index if index is not None else build_index(
        ds, p_claim, cfg, chunk_entries=chunk_entries,
        chunk_bytes=chunk_bytes, device=dev)
    bucketed = bucketize(idx, n_buckets)
    result, bstate = bound_detect(
        ds, p_claim, cfg, use_timers=True, l_threshold=16,
        index=idx, bucketed=bucketed, return_state=True, device=dev,
        stats=stats)
    t_book = time.perf_counter()
    E = idx.n_entries
    entry_bucket = (np.searchsorted(bucketed.starts, np.arange(E),
                                    side="right") - 1).astype(np.int32)

    # Prop-3.1 reference accuracies per entry (vectorized case split)
    acc = ds.accuracy.astype(np.float64)
    amin, asec, amax = entry_extreme_accuracies(idx.store, acc)
    a1_ref, a2_ref = prop31_reference_accs(
        idx.entry_p.astype(np.float64), amin, asec, amax, cfg)

    state = IncrementalState(
        index=idx, bucketed=bucketed, entry_bucket=entry_bucket,
        first_provider=first_providers(idx.store),
        p_old=idx.entry_p.copy(), score_old=idx.entry_score.copy(),
        a1_ref=a1_ref, a2_ref=a2_ref, acc_old=ds.accuracy.copy(),
        c_hat=bstate.c_hat, copying=torch.as_tensor(result.copying, device=dev),
        considered=bstate.considered, dec_bucket=bstate.dec_bucket,
        l_counts=torch.as_tensor(idx.l_counts, device=dev), err=bstate.err)
    if stats is not None:
        stats["bookkeeping_s"] = time.perf_counter() - t_book
    return result, state


def _big_change_deltas(state: IncrementalState, big: np.ndarray,
                       p_new: np.ndarray, acc_new: np.ndarray,
                       cfg: CopyConfig) -> tuple:
    """Pass 1a: exact float64 deltas of the big-change entries, summed per
    pair in entry order, each gated on the pair's decision point lying at
    or after the entry's bucket. Returns ((S, S) float64 deltas on the
    state's device, values examined)."""
    idx = state.index
    dev = state.c_hat.device
    S = state.c_hat.shape[0]
    acc_old = state.acc_old.astype(np.float64)
    rows, cols, diffs, buckets = [], [], [], []
    for e in np.nonzero(big)[0]:
        provs = idx.providers(e)
        P = len(provs)
        if P < 2:
            continue
        a_new = acc_new[provs]
        a_old = acc_old[provs]
        f_new = score_same_np(float(p_new[e]), a_new[:, None], a_new[None, :],
                              cfg.s, cfg.n)
        f_old = score_same_np(float(state.p_old[e]), a_old[:, None],
                              a_old[None, :], cfg.s, cfg.n)
        rows.append(np.repeat(provs, P))
        cols.append(np.tile(provs, P))
        diffs.append((f_new - f_old).ravel())
        buckets.append(np.full(P * P, state.entry_bucket[e], np.int32))
    d_c = torch.zeros((S, S), dtype=torch.float64, device=dev)
    if not rows:
        return d_c, 0
    r = torch.from_numpy(np.concatenate(rows)).to(dev)
    c = torch.from_numpy(np.concatenate(cols)).to(dev)
    gate = state.dec_bucket[r, c] >= torch.from_numpy(
        np.concatenate(buckets)).to(dev)
    d = torch.from_numpy(np.concatenate(diffs)).to(dev)
    # the JAX package adds each entry's gated block in turn; on the CPU the
    # accumulating index_put runs in that order, so the sums are bit-equal
    d_c.index_put_((r, c), torch.where(gate, d, 0.0), accumulate=True)
    return d_c, int((gate & (r < c)).sum().item())


def incremental_detect(
    ds: ClaimsDataset,
    p_claim: np.ndarray,
    cfg: CopyConfig,
    state: IncrementalState,
    rho: float = 1.0,
    rho_acc: float = 0.2,
    stats: dict | None = None,
) -> DetectionResult:
    """One incremental round on the state's device. Mutates ``state`` in
    place; ``stats``, when given, receives the round's pass-1 and rescore
    seconds (host clock, each ending in a device sync) and its counts."""
    t0 = time.perf_counter()
    idx = state.index
    dev = state.c_hat.device
    S = ds.n_sources
    E = idx.n_entries
    acc_new = ds.accuracy.astype(np.float64)

    # new entry probabilities via any provider's claim (padding columns of a
    # committed store have no providers — clamp the lookup and zero their
    # deltas so they never join the big/small classification)
    live = idx.entry_item >= 0
    p_new = p_claim[state.first_provider,
                    np.maximum(idx.entry_item, 0)].astype(np.float32)
    p_new = np.where(live, p_new, state.p_old)
    score_new = score_same_np(
        p_new.astype(np.float64), state.a1_ref, state.a2_ref, cfg.s, cfg.n
    ).astype(np.float32)
    delta = np.where(live, score_new - state.score_old, 0.0)
    big = np.abs(delta) > rho
    small_dec = (~big) & (delta < 0)
    small_inc = (~big) & (delta > 0)

    # ---- pass 1a: exact deltas from big-change entries -------------------
    d_c, values_examined = _big_change_deltas(state, big, p_new, acc_new, cfg)

    # ---- pass 1b: conservative batched bound for small changes -----------
    d_rho_dec = float(-delta[small_dec].min()) if small_dec.any() else 0.0
    d_rho_inc = float(delta[small_inc].max()) if small_inc.any() else 0.0
    cnt_dec, cnt_inc = masked_counts(idx.store, [small_dec, small_inc], dev)

    c_base = state.c_hat.double() + d_c
    del d_c
    # the bootstrap's accumulated p̂-error bound (zeroed wherever a previous
    # round rescored exactly) — the keep rules must hold BEYOND it, so kept
    # decisions stay provably exact for any index layout
    err = state.err.double()
    # worst case against the current decision, float64 as in the JAX
    # package (d_rho·count is a float32 product there, as here)
    was_copy = state.copying
    worst = c_base - d_rho_dec * cnt_dec - err
    del cnt_dec
    # copying pairs stay decided if even the worst-case decrease keeps them
    # over θ_cp
    keep = was_copy & (torch.maximum(worst, worst.T) >= cfg.theta_cp)
    worst = c_base + d_rho_inc * cnt_inc + err
    del cnt_inc, err
    # no-copying pairs stay decided if the worst-case increase keeps them
    # independent
    z_up = torch.logaddexp(worst, worst.T)
    del worst
    z_up += np.log(cfg.alpha / cfg.beta)
    keep |= (~was_copy) & (z_up < 0.0)
    del z_up

    big_acc = np.abs(acc_new - state.acc_old) > rho_acc
    big_acc_t = torch.from_numpy(big_acc).to(dev)
    acc_flag = big_acc_t[:, None] | big_acc_t[None, :]

    considered = state.considered
    candidates = considered & (~keep | acc_flag)
    del keep, acc_flag
    candidates = torch.triu(candidates, 1)
    n_cand = int(candidates.sum().item())
    n_considered = int(torch.triu(considered, 1).sum().item())
    state.pass1_settled = 1.0 - n_cand / max(n_considered, 1)

    # ---- passes 2–3 collapsed: exact rescore of candidates ---------------
    t_res = _synced(dev)
    c_fwd = c_base.to(torch.float32)
    del c_base
    pi, pj = torch.nonzero(candidates, as_tuple=True)
    del candidates
    if rescore_pairs_exact(*dataset_tensors(ds, p_claim, dev), cfg, pi, pj,
                           c_fwd):
        values_examined += int(state.l_counts[pi, pj].sum(
            dtype=torch.int64).item())
    c_fwd.fill_diagonal_(0.0)

    copying = decide_copying(c_fwd, c_fwd.T, cfg) & considered
    pr_ind = posterior_independence(c_fwd, c_fwd.T, cfg)
    pr_ind = torch.where(considered, pr_ind, 1.0)
    pr_ind.fill_diagonal_(1.0)
    copying.fill_diagonal_(False)

    # ---- fold updates back into the state ---------------------------------
    state.c_hat = c_fwd
    state.copying = copying
    state.p_old[big] = p_new[big]
    state.score_old[big] = score_new[big]
    state.acc_old[big_acc] = ds.accuracy[big_acc]
    if len(pi):
        state.err = state.err.clone()
        state.err[pi, pj] = 0.0                   # rescored ⇒ now exact
        state.err[pj, pi] = 0.0

    counter = ComputeCounter(
        pairs_considered=n_cand,
        shared_values_examined=values_examined,
        score_computations=2 * values_examined + 2 * n_cand,
        index_entries=E,
    )
    if stats is not None:
        stats.update({"big_entries": int(big.sum()), "candidates": n_cand,
                      "pass1_settled": state.pass1_settled,
                      "pass1_s": t_res - t0,
                      "rescore_s": _synced(dev) - t_res})
    return DetectionResult(c_fwd=c_fwd.cpu().numpy(),
                           pr_independent=pr_ind.cpu().numpy(),
                           copying=copying.cpu().numpy(), counter=counter,
                           wall_time_s=time.perf_counter() - t0)


__all__ = ["IncrementalState", "dataset_tensors", "first_providers",
           "incremental_detect", "make_incremental_state",
           "rescore_pairs_exact"]
