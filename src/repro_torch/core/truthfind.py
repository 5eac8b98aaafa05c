"""Iterative truth finding with copy-aware vote discounting (§II, [6]).

The port of the JAX package's ``core/truthfind.py``. Each round: (1) copy
detection → Pr(copy) per pair; (2) value-probability computation where each
source's vote is discounted by the probability that it provided the value
independently; (3) source-accuracy update. Repeat until the accuracies
converge (the motivating example converges in a few rounds, Table II).

Vote model (ACCU of Dong et al. [6]):
  vote weight      σ_s = ln(n·A_s / (1−A_s))
  independence     I_{s,e} = Π_{t ∈ S̄(e), (A_t,t) ≻ (A_s,s)} (1 − c·Pr(copy)[s,t])
                   (each provider discounted by higher-accuracy co-providers,
                    the paper's ordering trick to count each pair once)
  value vote       vote_e = Σ_{s ∈ S̄(e)} σ_s · I_{s,e}
  probability      P(e) = e^{vote_e} / (Σ_{e' ∈ item(e)} e^{vote_e'} + n₀·e⁰)
                   with n₀ = max(n − |observed values|, 0) unobserved false
                   values at vote 0
  accuracy         A_s = mean_e∈claims(s) P(e), clipped to [.01, .99]

The JAX package forms ln I as the dense product (L ⊙ H) @ V_all over every
(source, entry) cell, yet the votes read it only where V_all = 1, which is
0.13 % of the cells of the Book-full preset. ``vote_round`` sums each claim
over its entry's co-providers instead: Σ_e |S̄(e)|² terms (1.09 × 10⁸ at
Book-full, against the dense form's 11 TFLOP), in chunks of provider pairs
on the engine's device, then the normalization and the accuracy update as
segment sums over the claims. ``vote_round_dense`` is the JAX formula line
for line, chunked over entry columns: the plain version the tests and
``chip_smoke.py`` hold the sparse round against.

Rounds run detection through ``DetectionEngine`` on ``device`` (``None`` is
the card; a missing card raises). The entry probabilities and accuracies stay
on the device between rounds; the claim probabilities go to the engine as
numpy, as it takes them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.engine import DetectionEngine
from repro_torch.core.types import ClaimsDataset, CopyConfig, DetectionResult
from repro_torch.utils.device import resolve_device

# co-provider pairs one chunk of the sparse round materializes (~60 bytes of
# index and value temporaries a pair: ~1 GB at this size)
PAIR_CHUNK = 1 << 24
# entry columns one block of the dense plain version holds as float32
DENSE_BLOCK = 1 << 16


# ---------------------------------------------------------------------------
# Value groups: one entry per (item, value) INCLUDING singletons
# ---------------------------------------------------------------------------

@dataclass
class ValueGroups:
    """All distinct (item, value) claims, for vote computation.

    ``V_all`` — the (S, E_all) uint8 incidence of the JAX package — is built
    on first read only: the rounds read ``claim_entry``.
    """

    entry_item: np.ndarray   # (E_all,)
    claim_entry: np.ndarray  # (S, D) int32 — entry id of each claim, −1 missing
    n_values_per_item: np.ndarray  # (D,)
    _V_all: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def V_all(self) -> np.ndarray:
        """(S, E_all) uint8: V_all[s, e] = 1 iff source s provides entry e."""
        if self._V_all is None:
            S = self.claim_entry.shape[0]
            V = np.zeros((S, len(self.entry_item)), dtype=np.uint8)
            rows, cols = np.nonzero(self.claim_entry >= 0)
            V[rows, self.claim_entry[rows, cols]] = 1
            self._V_all = V
        return self._V_all


def build_value_groups(ds: ClaimsDataset) -> ValueGroups:
    """Group every claim by (item, value) — singletons included.

    Unlike the inverted index (shared values only, §III), truth finding
    votes over ALL distinct values. Entries are numbered as the JAX package
    numbers them: by the key item·max_v + value, ascending. Only the
    provided cells are keyed and sorted (3.5 % of the Book-full matrix)."""
    values = ds.values
    S, D = values.shape
    rows, cols = np.nonzero(values >= 0)
    max_v = int(values.max()) + 1 if len(rows) else 1
    key = cols.astype(np.int64) * max_v + values[rows, cols]
    uniq, inv = np.unique(key, return_inverse=True)
    claim_entry = np.full((S, D), -1, dtype=np.int32)
    claim_entry[rows, cols] = inv
    entry_item = (uniq // max_v).astype(np.int32)
    n_vals = np.bincount(entry_item, minlength=D).astype(np.int32)
    return ValueGroups(entry_item=entry_item, claim_entry=claim_entry,
                       n_values_per_item=n_vals)


@dataclass
class ClaimPairs:
    """The claims of a ``ValueGroups`` on a device, as ``vote_round`` reads
    them: sorted by entry (then source), each with the position of its
    entry's first claim and its entry's provider count, and the claim ranges
    whose provider pairs one chunk enumerates."""

    n_sources: int
    n_items: int
    src: torch.Tensor            # (C,) int64 — the claim's source
    ent: torch.Tensor            # (C,) int64 — the claim's entry
    first: torch.Tensor          # (C,) int64 — first claim of its entry
    size: torch.Tensor           # (C,) int64 — providers of its entry
    cell: torch.Tensor           # (C,) int64 — s·D + d of the claim
    entry_item: torch.Tensor     # (E_all,) int64
    n_vals: torch.Tensor         # (D,) float32
    claims_per_src: torch.Tensor  # (S,) float32, at least 1
    chunks: list                 # [(lo, hi, pairs)] claim ranges


def claim_pairs(groups: ValueGroups, device=None,
                pair_chunk: int = PAIR_CHUNK) -> ClaimPairs:
    """Move ``groups``'s claims onto ``device`` (``None`` → the card) in the
    sparse round's layout, with chunks of at most ~``pair_chunk`` provider
    pairs (a claim's pairs never split across chunks)."""
    dev = resolve_device(device)
    S, D = groups.claim_entry.shape
    rows, cols = np.nonzero(groups.claim_entry >= 0)
    ent = groups.claim_entry[rows, cols].astype(np.int64)
    order = np.argsort(ent, kind="stable")
    src, cols, ent = rows[order].astype(np.int64), cols[order], ent[order]
    E = len(groups.entry_item)
    counts = np.bincount(ent, minlength=E).astype(np.int64)
    starts = np.cumsum(counts) - counts
    size = counts[ent]
    ends = np.cumsum(size)
    chunks, lo = [], 0
    while lo < len(ent):
        base = ends[lo - 1] if lo else 0
        hi = max(int(np.searchsorted(ends, base + pair_chunk, side="right")),
                 lo + 1)
        chunks.append((lo, hi, int(ends[hi - 1] - base)))
        lo = hi
    per_src = np.maximum(np.bincount(src, minlength=S), 1).astype(np.float32)

    def put(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

    return ClaimPairs(
        n_sources=S, n_items=D, src=put(src), ent=put(ent),
        first=put(starts[ent]), size=put(size), cell=put(src * D + cols),
        entry_item=put(groups.entry_item),
        n_vals=put(groups.n_values_per_item, torch.float32),
        claims_per_src=put(per_src, torch.float32), chunks=chunks)


# ---------------------------------------------------------------------------
# One fusion round: the sparse co-provider sum, and its dense plain version
# ---------------------------------------------------------------------------

def vote_round(cp: ClaimPairs, acc: torch.Tensor, pr_copy: torch.Tensor,
               n: float, c: float):
    """→ (entry probability P(e), new accuracy A), float32 on ``cp``'s device.

    ln I of each claim (s, e) is Σ L[s, t] over the providers t of e that
    rank above s, enumerated chunk by chunk as (claim, co-provider) pairs,
    gathered from L and summed into the claim with ``index_add_``. σ, the
    rank and L are float32 in the JAX package's order of operations: two
    accuracies within about an ulp over S round to one rank, and then
    neither source discounts the other, as in JAX."""
    dev, S = acc.device, cp.n_sources
    sigma = torch.log(n * acc / (1.0 - acc))
    rank = acc * S + torch.arange(S, dtype=acc.dtype, device=dev)
    L_flat = torch.log1p(-torch.clamp(c * pr_copy, 0.0, 0.999)).reshape(-1)
    log_i = torch.zeros(cp.src.shape[0], dtype=torch.float32, device=dev)
    for lo, hi, m in cp.chunks:
        k = cp.size[lo:hi]
        claim = torch.repeat_interleave(
            torch.arange(hi - lo, device=dev), k, output_size=m)
        offset = torch.repeat_interleave(torch.cumsum(k, 0) - k, k,
                                         output_size=m)
        other = (cp.first[lo:hi][claim]
                 + torch.arange(m, device=dev) - offset)
        s = cp.src[lo:hi][claim]
        t = cp.src[other]
        term = torch.where(rank[t] > rank[s], L_flat[s * S + t], 0.0)
        log_i[lo:hi].index_add_(0, claim, term)
    votes = torch.zeros(cp.entry_item.shape[0], dtype=torch.float32,
                        device=dev)
    votes.index_add_(0, cp.ent, sigma[cp.src] * torch.exp(log_i))

    # per-item normalization incl. unobserved false values at vote 0; the
    # max starts from 0, so an item with no values gets JAX's clipped −inf
    seg_max = torch.zeros(cp.n_items, dtype=torch.float32, device=dev)
    seg_max.scatter_reduce_(0, cp.entry_item, votes, "amax")
    ex = torch.exp(votes - seg_max[cp.entry_item])
    denom_obs = torch.zeros_like(seg_max).index_add_(0, cp.entry_item, ex)
    denom = (denom_obs
             + torch.clamp(n - cp.n_vals, min=0.0) * torch.exp(-seg_max))
    p_entry = ex / denom[cp.entry_item]

    new_acc = torch.zeros(S, dtype=torch.float32, device=dev)
    new_acc.index_add_(0, cp.src, p_entry[cp.ent])
    return p_entry, torch.clamp(new_acc / cp.claims_per_src, 0.01, 0.99)


def vote_round_dense(groups: ValueGroups, acc: torch.Tensor,
                     pr_copy: torch.Tensor, n: float, c: float,
                     block: int = DENSE_BLOCK):
    """The plain version of ``vote_round``: the JAX package's ``_vote_round``
    line for line, with the dense ``(L ⊙ H) @ V_all`` over blocks of
    ``block`` entry columns of ``groups.V_all`` on ``acc``'s device (float32
    matmuls; TF32 as the caller set it, off by default). It shares no code
    with ``vote_round``."""
    dev, S = acc.device, acc.shape[0]
    V_all = groups.V_all
    E = V_all.shape[1]
    n_items = len(groups.n_values_per_item)
    entry_item = torch.as_tensor(groups.entry_item).to(dev, torch.int64)
    n_vals_per_item = torch.as_tensor(groups.n_values_per_item).to(dev)

    def columns(e0):                  # uint8 over the bus, float32 on dev
        return torch.from_numpy(V_all[:, e0:e0 + block]).to(dev).to(
            torch.float32)

    sigma = torch.log(n * acc / (1.0 - acc))                      # (S,)
    rank = acc * S + torch.arange(S, dtype=acc.dtype, device=dev)
    H = (rank[None, :] > rank[:, None]).to(torch.float32)
    L = torch.log1p(-torch.clamp(c * pr_copy, 0.0, 0.999))
    LH = L * H
    votes = torch.empty(E, dtype=torch.float32, device=dev)
    for e0 in range(0, E, block):
        V = columns(e0)
        log_i = LH @ V
        votes[e0:e0 + block] = torch.sum(V * sigma[:, None] * torch.exp(log_i),
                                         dim=0)

    seg_max = torch.full((n_items,), -torch.inf, device=dev).scatter_reduce(
        0, entry_item, votes, "amax")
    seg_max = torch.maximum(seg_max, torch.zeros((), device=dev))
    ex = torch.exp(votes - seg_max[entry_item])
    denom_obs = torch.zeros(n_items, device=dev).index_add(0, entry_item, ex)
    n_unobs = torch.maximum(n - n_vals_per_item.to(torch.float32),
                            torch.zeros((), device=dev))
    denom = denom_obs + n_unobs * torch.exp(-seg_max)
    p_entry = ex / denom[entry_item]

    dot = torch.zeros(S, device=dev)
    claims = torch.zeros(S, device=dev)
    for e0 in range(0, E, block):
        V = columns(e0)
        dot += V @ p_entry[e0:e0 + block]
        claims += torch.sum(V, dim=1)
    new_acc = dot / torch.maximum(claims, torch.ones((), device=dev))
    return p_entry, torch.clamp(new_acc, 0.01, 0.99)


# ---------------------------------------------------------------------------
# The iterative driver
# ---------------------------------------------------------------------------

# every detector is a DetectionEngine mode; keyword args go to EngineOptions
_ENGINE_MODE = {
    "pairwise": "pairwise",
    "index_exact": "exact",
    "index": "bucketed",
    "bound": "bound",
    "bound+": "bound+",
    "hybrid": "hybrid",
}


def _engine_detector(mode: str) -> Callable:
    def run(ds, p_claim, cfg, device=None, **kw):
        return DetectionEngine(cfg, mode=mode, device=device,
                               **kw).detect(ds, p_claim)
    return run


DETECTORS: dict[str, Callable] = {
    name: _engine_detector(mode) for name, mode in _ENGINE_MODE.items()
}


@dataclass
class FusionResult:
    """Converged truth-finding state plus per-round history/diagnostics."""

    accuracy: np.ndarray            # (S,) final accuracies
    p_entry: np.ndarray             # (E_all,) final value probabilities
    p_claim: np.ndarray             # (S, D) final claim probabilities
    groups: ValueGroups
    detection: DetectionResult
    rounds: int = 0
    accuracy_history: list = field(default_factory=list)
    p_history: list = field(default_factory=list)
    counters: list = field(default_factory=list)
    wall_time_s: float = 0.0
    detect_time_s: float = 0.0


def _claim_probs(cp: ClaimPairs, p_entry: torch.Tensor) -> np.ndarray:
    """(S, D) float32 numpy: each claim's entry probability, 0 where missing."""
    out = torch.zeros(cp.n_sources * cp.n_items, dtype=torch.float32,
                      device=p_entry.device)
    out[cp.cell] = p_entry[cp.ent]
    return out.reshape(cp.n_sources, cp.n_items).cpu().numpy()


def truth_finding(
    ds: ClaimsDataset,
    cfg: CopyConfig,
    detector: str | Callable = "hybrid",
    max_rounds: int = 12,
    tol: float = 5e-4,
    init_accuracy: float = 0.8,
    detector_kwargs: Optional[dict] = None,
    track_history: bool = False,
    device=None,
) -> FusionResult:
    """Iterative copy detection + truth finding + accuracy update (§II-A).

    ``detector`` is a name of ``DETECTORS``, ``"incremental"`` (HYBRID in
    round 1, then one ``DetectionEngine(mode="incremental")`` carried
    across rounds), or a callable ``(ds, p_claim, cfg, **detector_kwargs)
    → DetectionResult``. Engines and the vote round run on ``device``."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    kw = dict(detector_kwargs or {})
    inc_engine = None
    if detector == "incremental":
        detect = None
        inc_engine = DetectionEngine(cfg, mode="incremental", device=dev, **kw)
    elif isinstance(detector, str):
        detect = partial(DETECTORS[detector], device=dev)
    else:
        detect = detector
    groups = build_value_groups(ds)
    cp = claim_pairs(groups, dev)
    S = ds.n_sources

    # round 0: no copy knowledge yet — votes with Pr(copy)=0
    acc = torch.full((S,), init_accuracy, dtype=torch.float32, device=dev)
    p_entry, acc = vote_round(
        cp, acc, torch.zeros((S, S), dtype=torch.float32, device=dev),
        cfg.n, cfg.c)
    history, p_hist, counters = [], [], []
    detection = None
    detect_time = 0.0
    rnd = 0

    for rnd in range(1, max_rounds + 1):
        work = ClaimsDataset(values=ds.values, accuracy=acc.cpu().numpy())
        p_claim = _claim_probs(cp, p_entry)
        td0 = time.perf_counter()
        if inc_engine is not None:
            # §VI: HYBRID in the first round; round 2 bootstraps the engine's
            # incremental bookkeeping, later rounds apply per-round deltas
            if rnd < 2:
                detection = DetectionEngine(cfg, mode="hybrid", device=dev,
                                            **kw).detect(work, p_claim)
            else:
                detection = inc_engine.detect(work, p_claim)
        else:
            detection = detect(work, p_claim, cfg, **kw)
        detect_time += time.perf_counter() - td0
        counters.append(detection.counter)
        pr_copy = torch.from_numpy(
            (1.0 - detection.pr_independent).astype(np.float32)).to(dev)

        p_entry, new_acc = vote_round(cp, acc, pr_copy, cfg.n, cfg.c)
        if track_history:
            history.append(new_acc.cpu().numpy())
            p_hist.append(p_entry.cpu().numpy())
        delta = float(torch.max(torch.abs(new_acc - acc)))
        acc = new_acc
        if delta < tol:
            break

    return FusionResult(
        accuracy=acc.cpu().numpy(), p_entry=p_entry.cpu().numpy(),
        p_claim=_claim_probs(cp, p_entry), groups=groups, detection=detection,
        rounds=rnd, accuracy_history=history, p_history=p_hist,
        counters=counters, wall_time_s=time.perf_counter() - t0,
        detect_time_s=detect_time,
    )


def fusion_accuracy(result: FusionResult, ds: ClaimsDataset,
                    true_values: np.ndarray) -> float:
    """Fraction of items whose top-probability value is the true one.

    An item's top entry is the first of its maxima in entry order, and an
    entry's value is read from its lowest-index provider, as the JAX
    package's loop reads them; items whose entries all hold NaN count as
    having none."""
    p = np.asarray(result.p_entry)
    item = result.groups.entry_item
    live = np.nonzero(p > -np.inf)[0]
    # by item, then probability descending, then entry ascending
    order = live[np.lexsort((live, -p[live], item[live]))]
    head = np.ones(len(order), dtype=bool)
    head[1:] = item[order][1:] != item[order][:-1]
    best = order[head]
    claim_entry = result.groups.claim_entry
    rows, cols = np.nonzero(claim_entry >= 0)
    ents, first = np.unique(claim_entry[rows, cols], return_index=True)
    lowest = np.full(len(p), -1, np.int64)
    lowest[ents] = rows[first]                 # row-major: lowest source
    best = best[lowest[best] >= 0]
    d = item[best]
    v = ds.values[lowest[best], d]
    return int(np.sum(v == true_values[d])) / max(len(best), 1)


__all__ = ["ClaimPairs", "DETECTORS", "FusionResult", "ValueGroups",
           "build_value_groups", "claim_pairs", "fusion_accuracy",
           "truth_finding", "vote_round", "vote_round_dense"]
