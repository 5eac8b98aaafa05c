"""BOUND / BOUND+ / HYBRID (§IV) — early-terminating detection, in torch.

The scan terminates at *bucket* granularity: after each score-ordered bucket
it evaluates the paper's bounds for all active pairs at once,

  C^min = C⁰ + (l − n₀)·ln(1−s)                                  (Eq. 9)
  C^max = C⁰ + (h − n₀)·ln(1−s) + (l − h)·M                      (Eq. 10)
    h = clip(max(n(S1)·l/|D̄(S1)|, n(S2)·l/|D̄(S2)|), n₀, l)
    M = exact max score of the unscanned suffix (m_suffix)

and freezes pairs that cross θ_cp = ln β/α (copying) or fall below
θ_ind = ln β/2α (no-copying). Frozen pairs stop accumulating C⁰/n₀ (their
values at the decision point are what INCREMENTAL's bookkeeping needs),
while the total shared-value count n keeps counting (the paper's |Ē⋈|).
BOUND+ adds the per-pair re-check timers of §IV-B; HYBRID applies bounds
only to pairs sharing more than ``l_threshold`` items (default 16).

The JAX package jits one bucket step; here ``_bound_step`` is a plain torch
function over (S, S) tensors on the caller's device, keeping every carry
value in the JAX dtype (float32 scores and timers, int8 ``decided``, int32
``dec_bucket``) and every float32 expression in the JAX association, so the
CPU run freezes the same pairs in the same bucket. Each bucket's columns
are staged from the store as int8; the per-bucket count ``v_k·v_kᵀ`` is a
float32 product on the CPU (as in JAX) and an int8 → int32 tensor-core
product (``torch._int_mm``) on the card, both exact for 0/1 incidence. The
counters ``shared_values_examined`` and ``bound_computations`` are summed
exactly in float64 (JAX sums them in float32, which rounds past 2²⁴).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.index import (
    BucketedIndex,
    InvertedIndex,
    bucketize,
    build_index,
    canonicalized,
)
from repro_torch.core.scoring import (
    bucket_score_deltas,
    decide_copying,
    posterior_independence,
    score_same,
)
from repro_torch.core.store import CorpusStore
from repro_torch.core.types import ClaimsDataset, CopyConfig, DetectionResult
from repro_torch.kernels.ops import pair_scores
from repro_torch.utils.counters import ComputeCounter
from repro_torch.utils.device import resolve_device

#: entry columns per count product in ``masked_counts``
MASKED_SLAB_ENTRIES = 8192


@dataclass
class BoundState:
    """Post-scan per-pair state, (S, S) tensors on the scan's device,
    consumed by INCREMENTAL."""

    c0: torch.Tensor           # float32 C⁰→ at decision point (== final if undecided)
    n0: torch.Tensor           # float32 shared values seen at decision point
    n_full: torch.Tensor       # float32 total shared values (all buckets)
    decided: torch.Tensor      # int8: +1 copying, −1 no-copying, 0 till Step IV
    dec_bucket: torch.Tensor   # int32 bucket of the decision (K if undecided)
    considered: torch.Tensor   # bool: co-occur outside Ē
    c_hat: torch.Tensor        # float32 Ĉ→ = C⁰_dec + (l − n)·ln(1−s)
    err: torch.Tensor          # float32 Σ δ_k·count p̂-error bound on C⁰→


def _count_rows(S: int, dev: torch.device) -> int:
    """Rows of a count operand: ``torch._int_mm`` on the card takes more
    than 16 rows, a multiple of 8."""
    return max(-(-S // 8) * 8, 24) if dev.type == "cuda" else S


def _count_product(v: torch.Tensor) -> torch.Tensor:
    """v·vᵀ of a 0/1 operand: int8 → int32 on the card, float32 on the CPU
    (both exact for counts below 2²⁴); the caller pads v's columns to a
    multiple of 8 on the card."""
    if v.device.type == "cuda":
        return torch._int_mm(v, v.t())
    return v @ v.T


def masked_counts(store, masks, device) -> list:
    """Σ over the masked entries of V[:, e]·V[:, e]ᵀ, one (S, S) float32
    count per (E,) bool mask, exact.

    Each store chunk with a masked entry is staged once (int8); its masked
    columns collect, per mask, into slabs of ``MASKED_SLAB_ENTRIES`` columns
    on ``device``, and each full slab adds one count product. The JAX
    package sums these products in numpy chunk by chunk; exact integer
    counts make any grouping give the same matrix.
    """
    dev = torch.device(device)
    S = store.n_rows
    rows = _count_rows(S, dev)
    dt = torch.int8 if dev.type == "cuda" else torch.float32
    outs = [torch.zeros((rows, rows), dtype=torch.int32 if dt == torch.int8
                        else torch.float32, device=dev) for _ in masks]
    slabs = [torch.zeros((rows, MASKED_SLAB_ENTRIES), dtype=dt, device=dev)
             for _ in masks]
    fill = [0] * len(masks)

    def flush(i):
        w = -(-fill[i] // 8) * 8
        slabs[i][:, fill[i]:w] = 0
        outs[i] += _count_product(slabs[i][:, :w].contiguous())
        fill[i] = 0

    for ch in store.iter_chunks():
        sels = [np.nonzero(m[ch.start: ch.start + ch.width])[0] for m in masks]
        if not any(len(s) for s in sels):
            continue
        blk = torch.from_numpy(np.ascontiguousarray(ch.V)).to(dev)
        for i, sel in enumerate(sels):
            sel = torch.from_numpy(sel).to(dev)
            while len(sel):
                take = min(len(sel), MASKED_SLAB_ENTRIES - fill[i])
                slabs[i][:S, fill[i]:fill[i] + take] = blk[:, sel[:take]].to(dt)
                fill[i] += take
                sel = sel[take:]
                if fill[i] == MASKED_SLAB_ENTRIES:
                    flush(i)
    for i in range(len(masks)):
        if fill[i]:
            flush(i)
    return [o[:S, :S].to(torch.float32) for o in outs]


def _synced(dev: torch.device) -> float:
    """The host clock after the device's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@dataclass
class _Carry:
    """The 11 values threaded through the bucket scan (JAX's carry tuple)."""

    c0: torch.Tensor           # float32 (S, S)
    n0: torch.Tensor           # float32 (S, S)
    n_full: torch.Tensor       # float32 (S, S)
    nscan: torch.Tensor        # float32 (S,) entries scanned per source
    decided: torch.Tensor      # int8 (S, S)
    dec_bucket: torch.Tensor   # int32 (S, S), K = undecided
    min_due: torch.Tensor      # float32 (S, S) BOUND+ timer for C^min
    max_due: torch.Tensor      # float32 (S, S) BOUND+ timer for C^max
    err: torch.Tensor          # float32 (S, S)
    ve: torch.Tensor           # float64 () shared values examined, exact
    bc: torch.Tensor           # float64 () bound checks, exact


def _new_carry(S: int, K: int, dev: torch.device) -> _Carry:
    def z():
        return torch.zeros((S, S), dtype=torch.float32, device=dev)
    return _Carry(
        c0=z(), n0=z(), n_full=z(),
        nscan=torch.zeros(S, dtype=torch.float32, device=dev),
        decided=torch.zeros((S, S), dtype=torch.int8, device=dev),
        dec_bucket=torch.full((S, S), K, dtype=torch.int32, device=dev),
        min_due=z(), max_due=z(), err=z(),
        ve=torch.zeros((), dtype=torch.float64, device=dev),
        bc=torch.zeros((), dtype=torch.float64, device=dev))


def _bound_step(carry: _Carry, count, nscan_k, p_k, m_next, delta_k, k: int,
                acc, lf, d_src, considered, boundable, cfg: CopyConfig,
                n_false, use_timers: bool, K: int) -> None:
    """One score-ordered bucket of the BOUND scan (Eqs. 9–10 + timers),
    updating ``carry`` in place.

    ``count`` is the bucket's (S, S) float32 pair count and ``nscan_k`` its
    (S,) entries per source; ``p_k``, ``m_next``, ``delta_k`` and
    ``n_false`` (the config's n) are 0-dim float32 tensors on the device, so
    the card divides as the CPU does (by a tensor, not by a host scalar's
    reciprocal). Every freeze must hold beyond the pair's
    accumulated p̂ error ``err`` (Σ δ_k·count), which keeps frozen decisions
    equal to the exact INDEX for any bucketing.
    """
    c = carry
    ln1ms = cfg.ln_1ms
    active = (c.decided == 0) & considered
    f = score_same(p_k, acc[:, None], acc[None, :], cfg.s, n_false)
    upd = active.to(torch.float32) * count
    del active
    c.c0 += f * upd
    del f
    c.n0 += upd
    c.err += delta_k * upd
    c.n_full += count * considered
    c.nscan += nscan_k
    c.ve += torch.triu(upd, 1).sum(dtype=torch.float64)
    del upd

    # ---- bounds (Eqs. 9–10), tightened by the accumulated p̂ error ----
    c_min = c.c0 - c.err + (lf - c.n0) * ln1ms
    c_min = torch.maximum(c_min, c_min.T)
    d = d_src.clamp(min=1.0)
    h = torch.maximum(c.nscan[:, None] * lf / d[:, None],
                      c.nscan[None, :] * lf / d[None, :])
    h = torch.clamp(h, min=c.n0, max=lf)
    h_n0 = h - c.n0
    c_max = c.c0 + c.err + h_n0 * ln1ms + (lf - h) * m_next
    del h
    c_max = torch.maximum(c_max, c_max.T)

    checkable = (c.decided == 0) & considered & boundable
    if use_timers:
        check_min = checkable & (c.n0 >= c.min_due)
        check_max = checkable & (h_n0 >= c.max_due)
    else:
        check_min = check_max = checkable
    del checkable
    c.bc += (torch.triu(check_min, 1).sum(dtype=torch.float64)
             + torch.triu(check_max, 1).sum(dtype=torch.float64))

    cp = check_min & (c_min >= cfg.theta_cp)
    ind = check_max & (c_max < cfg.theta_ind) & (c_max.T < cfg.theta_ind) & ~cp

    if use_timers:
        denom = torch.clamp(m_next - ln1ms, min=1e-6)
        t_min = torch.ceil((cfg.theta_cp - c_min) / denom)
        c.min_due = torch.where(check_min & ~cp, c.n0 + t_min, c.min_due)
        del t_min
        t0_max = torch.ceil((c_max - cfg.theta_ind) / denom)
        c.max_due = torch.where(check_max & ~ind, h_n0 + t0_max, c.max_due)
        del t0_max
    del c_min, c_max, h_n0, check_min, check_max

    newly = cp.to(torch.int8) - ind.to(torch.int8)    # cp and ind exclusive
    fresh = newly != 0
    c.decided = torch.where((c.decided == 0) & fresh, newly, c.decided)
    c.dec_bucket.masked_fill_((c.dec_bucket == K) & fresh, k)


def _stage_columns(store, e0: int, e1: int, rows: int, dev: torch.device,
                   staged: dict) -> torch.Tensor:
    """Entry columns [e0, e1) of the store as an int8 (rows, w) tensor on
    ``dev``, w rounded up to a multiple of 8 with zero columns: assembled on
    the device from whole chunks, each uploaded as the contiguous block it
    is (``staged`` keeps the last one for the next range, which usually
    starts in it)."""
    S = store.n_rows
    w = max(-(-(e1 - e0) // 8) * 8, 8)
    v = torch.zeros((rows, w), dtype=torch.int8, device=dev)
    cw = store.chunk_entries
    for c in range(e0 // cw, min(-(-e1 // cw), store.n_chunks)):
        s0 = store.chunk_start(c)
        lo, hi = max(e0, s0), min(e1, s0 + store.chunk_width(c))
        if lo >= hi:
            continue
        if staged.get("chunk") != c:
            staged["chunk"] = c
            # a sharded store assembles the chunk's rows through its facade
            blk = (store.chunks[c][:S] if isinstance(store, CorpusStore)
                   else store.assemble_rows(c, 0, S))
            staged["block"] = torch.from_numpy(blk).to(dev)
        v[:S, lo - e0: hi - e0] = staged["block"][:, lo - s0: hi - s0]
    return v


def _bound_stream(idx: InvertedIndex, b: BucketedIndex, acc: np.ndarray,
                  considered, boundable, cfg: CopyConfig, use_timers: bool,
                  dev: torch.device) -> _Carry:
    """Drive the bucket step over buckets staged from the store one at a
    time (int8): peak incidence residency is one bucket, never (K, S, w)."""
    S = idx.n_sources
    K = b.n_buckets
    starts = b.starts
    rows = _count_rows(S, dev)
    p_lo = b.p_lo if b.p_lo is not None else b.p_hat
    p_hi = b.p_hi if b.p_hi is not None else b.p_hat
    deltas = (bucket_score_deltas(b.p_hat, p_lo, p_hi, acc, cfg) if K
              else np.zeros(0, np.float32))

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    carry = _new_carry(S, K, dev)
    n_false = f32(cfg.n)
    acc_t = torch.as_tensor(np.asarray(acc, np.float32), device=dev)
    lf = torch.as_tensor(idx.l_counts, device=dev).to(torch.float32)
    d_src = torch.as_tensor(np.asarray(idx.items_per_source, np.float32),
                            device=dev)
    staged: dict = {}
    for k in range(K):
        v = _stage_columns(idx.store, int(starts[k]), int(starts[k + 1]),
                           rows, dev, staged)
        if dev.type != "cuda":
            v = v.to(torch.float32)
        count = _count_product(v)[:S, :S].to(torch.float32)
        nscan_k = v[:S].sum(dim=1, dtype=torch.float32)
        del v
        _bound_step(carry, count, nscan_k, f32(b.p_hat[k]),
                    f32(b.m_suffix[k + 1]), f32(deltas[k]), k, acc_t, lf,
                    d_src, considered, boundable, cfg, n_false, use_timers, K)
        del count
    return carry


def bound_detect(
    ds: ClaimsDataset,
    p_claim: np.ndarray,
    cfg: CopyConfig,
    n_buckets: int = 64,
    use_timers: bool = False,          # False = BOUND, True = BOUND+
    l_threshold: int = 0,              # >0 = HYBRID (INDEX for small-overlap pairs)
    rescore_margin: float = 1.0,
    index: InvertedIndex | None = None,
    bucketed: BucketedIndex | None = None,
    return_state: bool = False,
    device=None,
    stats: dict | None = None,
):
    """BOUND (§IV-A), BOUND+ (§IV-B, use_timers), HYBRID (l_threshold=16),
    on ``device`` (None → the card).

    Returns a ``DetectionResult`` (numpy fields), and with ``return_state``
    also the ``BoundState`` (tensors on ``device``). ``stats``, when given,
    receives the stage seconds (host clock, each ending in a device sync)
    and the rescored pair count.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    idx = index if index is not None else build_index(ds, p_claim, cfg,
                                                      device=dev)
    if bucketed is None:
        # a committed index is re-gathered into score-sorted prefix-Ē form
        # first, so the bucket geometry (and Eq. 10's scan-order-dependent h
        # estimate) matches a from-scratch rebuild exactly
        idx = canonicalized(idx, cfg)
        bucketed = bucketize(idx, n_buckets)
    S = ds.n_sources
    ln1ms = cfg.ln_1ms

    # considered = co-occurrence outside Ē (the mask form covers committed
    # indexes, where Ē is no longer a physical suffix)
    t_cons = time.perf_counter()
    considered = masked_counts(idx.store, [idx.nonebar_mask], dev)[0] > 0.5
    considered.fill_diagonal_(False)
    t_scan = _synced(dev)
    lf = torch.as_tensor(idx.l_counts, device=dev).to(torch.float32)
    boundable = lf > l_threshold
    boundable.fill_diagonal_(False)

    carry = _bound_stream(idx, bucketed, ds.accuracy, considered, boundable,
                          cfg, use_timers, dev)
    del boundable
    t_fin = _synced(dev)
    c0, n0, decided, err = carry.c0, carry.n0, carry.decided, carry.err

    # Step IV for still-active pairs (n0 == n_full there): C→ = C^min
    c_fwd = torch.where(considered, c0 + (lf - n0) * ln1ms, 0.0)
    c_fwd.fill_diagonal_(0.0)
    # Ĉ for incremental bookkeeping (§V preparation step)
    c_hat = torch.where(considered, c0 + (lf - carry.n_full) * ln1ms, 0.0)
    del lf

    # a still-active pair's decision can only differ from the exact INDEX if
    # the accumulated p̂ error reaches its decision margin — widen the band
    # by it, exactly as the engine's rescore does (z in float64, as the JAX
    # package's numpy computes it)
    z = (torch.logaddexp(c_fwd, c_fwd.T).double()
         + np.log(cfg.alpha / cfg.beta)).abs_()
    near = (decided == 0) & considered
    near &= z < rescore_margin + torch.maximum(err, err.T)
    del z
    pi, pj = torch.nonzero(torch.triu(near, 1), as_tuple=True)
    del near
    t_res = time.perf_counter()
    if len(pi):
        vals = torch.as_tensor(ds.values, device=dev)
        p = torch.as_tensor(np.asarray(p_claim, np.float32), device=dev)
        acc = torch.as_tensor(ds.accuracy, dtype=torch.float32, device=dev)
        c_ij, c_ji = pair_scores(vals, p, acc, pi, pj, s=cfg.s, n_false=cfg.n)
        c_fwd[pi, pj] = c_ij
        c_fwd[pj, pi] = c_ji
        del vals, p, acc

    step4 = decide_copying(c_fwd, c_fwd.T, cfg)
    copying = torch.where(decided != 0, decided > 0, step4) & considered
    del step4
    pr_ind = posterior_independence(c_fwd, c_fwd.T, cfg)
    pr_ind = torch.where(considered, pr_ind, 1.0)
    pr_ind = torch.where(decided > 0, pr_ind.clamp(max=0.5), pr_ind)
    pr_ind = torch.where(decided < 0, pr_ind.clamp(min=0.5), pr_ind)
    pr_ind.fill_diagonal_(1.0)
    copying.fill_diagonal_(False)

    n_pairs = int(torch.triu(considered, 1).sum().item())
    ve, bc = int(carry.ve.item()), int(carry.bc.item())
    if stats is not None:
        stats.update({"buckets": bucketed.n_buckets,
                      "considered_s": t_scan - t_cons,
                      "bound_scan_s": t_fin - t_scan,
                      "rescored_pairs": len(pi),
                      "rescore_s": _synced(dev) - t_res})
    counter = ComputeCounter(
        pairs_considered=n_pairs,
        shared_values_examined=ve,
        score_computations=2 * ve + 2 * n_pairs + 2 * len(pi),
        bound_computations=2 * bc,
        index_entries=idx.n_entries,
    )
    result = DetectionResult(
        c_fwd=c_fwd.cpu().numpy(), pr_independent=pr_ind.cpu().numpy(),
        copying=copying.cpu().numpy(), counter=counter,
        wall_time_s=time.perf_counter() - t0)
    if return_state:
        state = BoundState(c0=c0, n0=n0, n_full=carry.n_full,
                           decided=decided, dec_bucket=carry.dec_bucket,
                           considered=considered, c_hat=c_hat, err=err)
        return result, state
    return result


def hybrid_detect(ds, p_claim, cfg, n_buckets: int = 64, **kw):
    """HYBRID: INDEX semantics for pairs sharing ≤16 items, BOUND+ beyond."""
    return bound_detect(ds, p_claim, cfg, n_buckets=n_buckets,
                        use_timers=True, l_threshold=16, **kw)


__all__ = ["BoundState", "bound_detect", "hybrid_detect", "masked_counts"]
