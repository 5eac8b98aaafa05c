"""The specialized inverted index (§III, Definition 3.2).

One entry per *shared* value D.v (≥ 2 providers), carrying

  * P(E)  — probability the value is true,
  * C(E)  — contribution score M̂(D.v), the maximum possible pair
            contribution, computable from only the extreme-accuracy
            providers (Proposition 3.1),
  * S̄(E) — the provider set, stored as a column of the source×entry
            incidence matrix V.

Entries are sorted in decreasing C(E) (the BYCONTRIBUTION order of §VI-C);
the low-score suffix Ē (Σ C(E) < ln β/2α) can never flip a pair to copying
on its own, so pairs that co-occur only inside Ē are skipped.

Index construction is host-side numpy, streamed into a chunked
``CorpusStore``, except the pair item counts ``l_counts``: that product is
O(S²·D), so it runs as one float32 matrix product on the device.

This slice carries the build, the engine's chunk view and the state-dict
load; commit/retract/compaction are not carried yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.scoring import score_same_np
from repro_torch.core.store import DEFAULT_CHUNK_ENTRIES, CorpusStore, align_chunk
from repro_torch.core.types import ClaimsDataset, CopyConfig
from repro_torch.utils.device import resolve_device


@dataclass
class InvertedIndex:
    """Entries sorted by decreasing contribution score, backed by a
    chunked ``CorpusStore``. Ē is the prefix split at ``ebar_start``, or
    the explicit ``ebar_mask`` of an index captured after commits."""

    store: CorpusStore         # entry-chunked incidence + entry metadata
    ebar_start: int            # entries [ebar_start:] form Ē (prefix form)
    l_counts: np.ndarray       # (S, S) int32 — shared-item counts l(S1,S2)
    items_per_source: np.ndarray  # (S,) int32 — |D̄(S)|
    ebar_mask: Optional[np.ndarray] = None  # (E,) bool Ē membership (wins
                                            # over ebar_start when set)

    @property
    def n_entries(self) -> int:
        """|E| — number of shared-value entries (columns of V)."""
        return self.store.n_entries

    @property
    def n_sources(self) -> int:
        """|S| — number of live sources (rows of V)."""
        return self.store.n_rows

    @property
    def entry_item(self) -> np.ndarray:
        """(E,) int32 — D_E per entry (view into the store)."""
        return self.store.entry_item

    @property
    def entry_value(self) -> np.ndarray:
        """(E,) int32 — v_E per entry (view into the store)."""
        return self.store.entry_value

    @property
    def entry_p(self) -> np.ndarray:
        """(E,) float32 — P(E) per entry (view into the store)."""
        return self.store.entry_p

    @property
    def entry_score(self) -> np.ndarray:
        """(E,) float32 — C(E) per entry, non-increasing (view)."""
        return self.store.entry_score

    @property
    def live_mask(self) -> np.ndarray:
        """(E,) bool — True for real entry columns (False for inert padding)."""
        return self.store.entry_item >= 0

    @property
    def nonebar_mask(self) -> np.ndarray:
        """(E,) bool — live entries OUTSIDE Ē (the consumer-facing Ē API)."""
        live = self.live_mask
        if self.ebar_mask is not None:
            return live & ~self.ebar_mask
        pre = np.arange(self.store.n_entries) < self.ebar_start
        return live & pre

    def providers(self, e: int) -> np.ndarray:
        """S̄(E) — indices of the sources providing the value of entry ``e``."""
        return self.store.providers(e)

    # -- (de)serialization --------------------------------------------------

    def state_dict(self) -> dict:
        """Flat ``{key: ndarray}`` dict capturing this index bit-exactly —
        the key set of the JAX package's ``InvertedIndex.state_dict``."""
        d = self.store.state_dict()
        d["index/meta"] = np.array(
            [self.ebar_start, 0 if self.ebar_mask is None else 1], np.int64)
        if self.ebar_mask is not None:
            d["index/ebar_mask"] = self.ebar_mask.astype(np.uint8)
        d["index/l_counts"] = self.l_counts
        d["index/items_per_source"] = self.items_per_source
        return d

    @classmethod
    def from_state_dict(cls, d: dict,
                        row_capacity: Optional[int] = None) -> "InvertedIndex":
        """Rebuild an index from a ``state_dict`` — this package's or the
        JAX package's, which share one key set — bit-exact, without a
        rebuild. A row-range-sharded capture (``store/shard_starts``) is
        refused until the shard plane is ported."""
        if "store/shard_starts" in d:
            raise NotImplementedError(
                "sharded index state (store/shard_starts) needs the shard "
                "plane, which is not ported yet (ROADMAP A10)")
        meta = np.asarray(d["index/meta"], np.int64)
        ebar_mask = None
        if int(meta[1]):
            ebar_mask = np.asarray(d["index/ebar_mask"], np.uint8).astype(bool)
        return cls(
            store=CorpusStore.from_state_dict(d, capacity=row_capacity),
            ebar_start=int(meta[0]),
            l_counts=np.asarray(d["index/l_counts"], np.int32),
            items_per_source=np.asarray(d["index/items_per_source"], np.int32),
            ebar_mask=ebar_mask)


def entry_contribution_score(
    p: float, provider_accs: np.ndarray, cfg: CopyConfig
) -> float:
    """Proposition 3.1 — M̂(D.v) from the extreme-accuracy providers.

    Case 1 (A_min ≤ 1/(1 + nP/(1−P))):       S1 = max-acc,   S2 = min-acc
    Case 2 (else, P < .5):                    S1 = 2nd-min,   S2 = min-acc
    Case 3 (else):                            S1 = min-acc,   S2 = 2nd-min
    """
    accs = np.sort(np.asarray(provider_accs, dtype=np.float64))
    a_min, a_second, a_max = accs[0], accs[min(1, len(accs) - 1)], accs[-1]
    p = float(p)
    threshold = 1.0 / (1.0 + cfg.n * p / max(1.0 - p, 1e-12))
    if a_min <= threshold:
        a1, a2 = a_max, a_min
    elif p < 0.5:
        a1, a2 = a_second, a_min
    else:
        a1, a2 = a_min, a_second
    return float(score_same_np(p, a1, a2, cfg.s, cfg.n))


def prop31_reference_accs(
    p: np.ndarray, a_min: np.ndarray, a_second: np.ndarray, a_max: np.ndarray,
    cfg: CopyConfig,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized Prop-3.1 case split → the (A_1, A_2) pair per entry."""
    threshold = 1.0 / (1.0 + cfg.n * p / np.maximum(1.0 - p, 1e-12))
    case1 = a_min <= threshold
    case2 = (~case1) & (p < 0.5)
    a1 = np.where(case1, a_max, np.where(case2, a_second, a_min))
    a2 = np.where(case1, a_min, np.where(case2, a_min, a_second))
    return a1, a2


def _entry_scores_vectorized(
    p: np.ndarray, a_min: np.ndarray, a_second: np.ndarray, a_max: np.ndarray,
    cfg: CopyConfig,
) -> np.ndarray:
    """Vectorized Prop 3.1 over all entries."""
    a1, a2 = prop31_reference_accs(p, a_min, a_second, a_max, cfg)
    return score_same_np(p.astype(np.float64), a1, a2, cfg.s, cfg.n).astype(np.float32)


def pair_item_counts(values: np.ndarray, device=None) -> np.ndarray:
    """``l_counts`` — (S, S) int32 shared-item counts, prov·provᵀ.

    One float32 matrix product on ``device``: 0/1 products sum to exact
    integers in float32 while the item count stays below 2²⁴, and the sum
    is cast back to int32 on the host.
    """
    S, D = values.shape
    if D >= 1 << 24:
        raise ValueError(f"pair_item_counts: {D} items exceed float32's "
                         f"exact integer range (2**24)")
    dev = resolve_device(device)
    prov = torch.as_tensor(values, device=dev) >= 0
    prov = prov.to(torch.float32)
    return (prov @ prov.T).to(torch.int32).cpu().numpy()


def build_index(
    ds: ClaimsDataset,
    p_claim: np.ndarray,
    cfg: CopyConfig,
    chunk_entries: Optional[int] = None,
    chunk_bytes: Optional[int] = None,
    row_capacity: Optional[int] = None,
    device=None,
) -> InvertedIndex:
    """Build the inverted index for a claims dataset, streaming into chunks.

    p_claim[s, d] is the truth probability of the value s provides on d
    (identical across providers of the same value).

    The incidence is written one ``(S, chunk_entries)`` chunk at a time —
    the peak single incidence allocation is one chunk, never ``(S, E)``.
    ``chunk_bytes`` derives the chunk width from a byte budget for that
    peak allocation (it wins over ``chunk_entries``); ``row_capacity``
    preallocates slack rows. ``l_counts`` is computed on ``device``
    (``None`` → the card).
    """
    values = ds.values
    S, D = values.shape
    prov = values >= 0

    cap = S if row_capacity is None else max(int(row_capacity), S)
    if chunk_bytes is not None:
        # the byte budget is a CEILING on one chunk allocation — round the
        # derived width DOWN to the 8-entry alignment (floored at 8)
        chunk_entries = max(((chunk_bytes // max(cap, 1)) // 8) * 8, 8)
    if chunk_entries is None:
        chunk_entries = DEFAULT_CHUNK_ENTRIES
    chunk_entries = align_chunk(chunk_entries)

    # --- group claims by (item, value): vectorized via a composite key -----
    max_v = int(values.max()) + 1 if values.size and values.max() >= 0 else 1
    key = np.where(prov, np.arange(D, dtype=np.int64)[None, :] * max_v + values, -1)
    flat_key = key.ravel()
    claim_src = np.repeat(np.arange(S, dtype=np.int32), D)
    valid = flat_key >= 0
    flat_key, claim_src = flat_key[valid], claim_src[valid]
    flat_p = p_claim.ravel()[valid].astype(np.float32)

    order = np.argsort(flat_key, kind="stable")
    flat_key, claim_src, flat_p = flat_key[order], claim_src[order], flat_p[order]
    uniq_key, starts, counts = np.unique(flat_key, return_index=True, return_counts=True)

    shared = counts >= 2                       # Def. 3.2: ≥ 2 providers
    e_keys = uniq_key[shared]
    e_starts = starts[shared]
    e_counts = counts[shared]
    E = len(e_keys)

    entry_item = (e_keys // max_v).astype(np.int32)
    entry_value = (e_keys % max_v).astype(np.int32)
    entry_p = flat_p[e_starts]

    # extreme provider accuracies per entry: sort claims by (key, accuracy)
    # once, then the group's first / second / last positions are the extremes
    acc = ds.accuracy.astype(np.float64)
    acc_claims = acc[claim_src]
    by_acc = np.lexsort((acc_claims, flat_key))
    acc_sorted = acc_claims[by_acc]
    a_min = acc_sorted[e_starts]
    a_second = acc_sorted[e_starts + 1]                  # counts ≥ 2 (Def 3.2)
    a_max = acc_sorted[e_starts + e_counts - 1]

    entry_score = _entry_scores_vectorized(entry_p, a_min, a_second, a_max, cfg)

    # sort entries by decreasing contribution score (metadata only — the
    # incidence is scattered straight into its final, sorted column below)
    order = np.argsort(-entry_score, kind="stable")
    rank = np.empty(E, np.int64)
    rank[order] = np.arange(E)
    entry_item = entry_item[order]
    entry_value = entry_value[order]
    entry_p = entry_p[order]
    entry_score = entry_score[order]

    # stream the incidence into chunks: each claim of a shared group lands at
    # (source, rank-of-its-entry); groups are contiguous in the key-sorted
    # flat arrays, so the per-claim column is one gather
    group_id = np.repeat(np.arange(len(uniq_key)), counts)
    entry_of_group = np.cumsum(shared) - 1
    in_shared = shared[group_id]
    claim_col = rank[entry_of_group[group_id[in_shared]]]
    store = CorpusStore.from_claim_coords(
        claim_src[in_shared], claim_col, S, entry_item, entry_value,
        entry_p, entry_score, chunk_entries=chunk_entries, capacity=cap)

    # Ē — maximal low-score suffix with Σ C(E) < ln(β/2α)
    ebar_start = _ebar_boundary(entry_score, cfg.theta_ind)

    return InvertedIndex(
        store=store,
        ebar_start=ebar_start,
        l_counts=pair_item_counts(values, device),
        items_per_source=prov.sum(axis=1).astype(np.int32),
    )


def _ebar_boundary(scores_desc: np.ndarray, theta_ind: float) -> int:
    """First index of the maximal low-score suffix with Σ max(C, 0) < θ_ind.

    ``scores_desc`` is a decreasing-score sequence.
    """
    pos = np.maximum(np.asarray(scores_desc, np.float64), 0.0)
    if not len(pos):
        return 0
    suffix = np.cumsum(pos[::-1])[::-1]
    below = suffix < theta_ind
    return int(np.argmax(below)) if below.any() else len(pos)


def _segment_p_stats(entry_p: np.ndarray, live: np.ndarray,
                     bounds: np.ndarray) -> tuple:
    """Per-segment (p̂, p_lo, p_hi) over the LIVE columns of each
    ``[bounds[k], bounds[k+1])`` range — geometric-mean representative and
    true extremes, 0.5 fallbacks for all-padding segments.
    """
    logp = np.log(np.clip(entry_p, 1e-9, 1.0))
    K = len(bounds) - 1
    p_hat = np.empty(K, np.float32)
    p_lo = np.empty(K, np.float32)
    p_hi = np.empty(K, np.float32)
    for k in range(K):
        seg = slice(int(bounds[k]), int(bounds[k + 1]))
        m = live[seg]
        lp = logp[seg] if m.all() else logp[seg][m]
        ps = entry_p[seg] if m.all() else entry_p[seg][m]
        p_hat[k] = float(np.exp(lp.mean())) if len(lp) else 0.5
        p_lo[k] = float(ps.min()) if len(ps) else 0.5
        p_hi[k] = float(ps.max()) if len(ps) else 0.5
    return p_hat, p_lo, p_hi


@dataclass
class EngineChunks:
    """The engine's chunk-handle view of an index.

    Entries are re-sorted by truth probability within the non-Ē prefix and
    within Ē (the tiled accumulation is order-insensitive; only the Ē
    boundary must stay exact), each region is zero-padded to a chunk
    multiple, and the result is a uniform-width ``CorpusStore`` whose chunks
    double as the kernel's entry blocks: each chunk k carries one
    representative p̂_k, its true p extremes (for the rescore bound δ_k),
    and a non-Ē flag. Row capacity is padded to the engine's tile grid so
    chunk arrays slice straight into pair tiles.
    """

    store: CorpusStore        # p-ordered regions, uniform chunk width
    p_hat: np.ndarray         # (K,) float32 — representative p̂ per chunk
    p_lo: np.ndarray          # (K,) float32 — min live p per chunk
    p_hi: np.ndarray          # (K,) float32 — max live p per chunk
    nout: np.ndarray          # (K,) float32 — 1.0 ⇔ chunk before Ē boundary
    ebar_chunk: int           # chunks [ebar_chunk:] lie fully inside Ē
    n_live: int               # E — real (non-padding) entries
    order: np.ndarray = None  # gathered column j = base column order[j] (−1 pad)

    @property
    def n_chunks(self) -> int:
        """K — number of uniform-width entry chunks."""
        return self.store.n_chunks

    @property
    def width(self) -> int:
        """Chunk width (= the kernel entry-block size)."""
        return self.store.chunk_entries


def engine_chunks(
    index: InvertedIndex,
    n_buckets: int = 64,
    row_capacity: Optional[int] = None,
    max_width: Optional[int] = None,
) -> EngineChunks:
    """Build the engine's uniform-width chunk store from an index.

    The chunk width is ``ceil(E / n_buckets)`` aligned up to 8, so
    ``n_buckets`` keeps its meaning as the p̂ granularity; the Ē boundary
    is chunk-aligned by construction (each region is padded with inert zero
    columns), which keeps the kernel's per-chunk non-Ē channel exact.
    ``max_width`` caps the chunk width from above (the engine derives it
    from its per-pass byte budget).
    """
    nonebar = index.nonebar_mask
    live = index.live_mask
    non = np.nonzero(nonebar)[0]
    ebar = np.nonzero(live & ~nonebar)[0]
    n_live = len(non) + len(ebar)
    cap = index.n_sources if row_capacity is None else int(row_capacity)
    if n_live == 0:
        empty = index.store.gather_entries(np.zeros(0, np.int64), capacity=cap)
        z = np.zeros(0, np.float32)
        return EngineChunks(store=empty, p_hat=z, p_lo=z, p_hi=z, nout=z,
                            ebar_chunk=0, n_live=0,
                            order=np.zeros(0, np.int64))

    b = align_chunk(-(-n_live // max(int(n_buckets), 1)))
    if max_width is not None:
        b = min(b, max(8, (int(max_width) // 8) * 8))
    order_pre = non[np.argsort(index.entry_p[non], kind="stable")]
    order_suf = ebar[np.argsort(index.entry_p[ebar], kind="stable")]
    pad0 = (-len(non)) % b
    pad1 = (-len(ebar)) % b
    order = np.concatenate([
        order_pre, np.full(pad0, -1, np.int64),
        order_suf, np.full(pad1, -1, np.int64),
    ])
    store = index.store.gather_entries(order, chunk_entries=b,
                                       capacity=cap)
    K = store.n_chunks
    ebar_chunk = (len(non) + pad0) // b

    p_hat, p_lo, p_hi = _segment_p_stats(
        store.entry_p, store.entry_item >= 0, np.arange(K + 1) * b)
    nout = (np.arange(K) < ebar_chunk).astype(np.float32)
    return EngineChunks(store=store, p_hat=p_hat, p_lo=p_lo, p_hi=p_hi,
                        nout=nout, ebar_chunk=ebar_chunk, n_live=n_live,
                        order=order)


__all__ = ["EngineChunks", "InvertedIndex", "build_index", "engine_chunks",
           "entry_contribution_score", "pair_item_counts",
           "prop31_reference_accs"]
