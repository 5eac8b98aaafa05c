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

Live mutation, as in the JAX package: ``commit_rows`` folds accepted query
rows into an index without rebuilding it (membership bits for existing
entries, **delta chunks** for newly shared values, refreshed contribution
scores where a provider set grew, block updates of ``l_counts``, and an Ē
**mask** re-derived from the merged score metadata without re-sorting the
incidence); ``retract_rows`` drops sources; ``rollback_commit`` restores
the state before either, bit-exact; ``compact_index`` folds deltas back
into one score-sorted base. ``bucketize`` / ``bucketize_engine`` are the
legacy variable-width bucket views the per-tile copyscore baseline reads.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.scoring import score_same_np
from repro_torch.core.store import (
    DEFAULT_CHUNK_ENTRIES,
    CorpusStore,
    StoreSnapshot,
    _nonzero_2d,
    align_chunk,
)
from repro_torch.core.shardplan import ShardedCorpusStore
from repro_torch.core.types import (
    CLAIM_KEY_BASE,
    ClaimsDataset,
    CopyConfig,
    claim_value_keys,
)
from repro_torch.utils.device import resolve_device


@dataclass
class InvertedIndex:
    """Entries sorted by decreasing contribution score, backed by a
    chunked ``CorpusStore``. Ē is the prefix split at ``ebar_start``, or
    the explicit ``ebar_mask`` of an index captured after commits."""

    store: CorpusStore         # entry-chunked incidence + entry metadata
                               # (or its row-range-sharded facade)
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

    @property
    def V(self) -> np.ndarray:
        """Dense (S, E) incidence — compat/debug accessor ONLY (a view for a
        single-chunk store, a copy otherwise)."""
        return self.store.to_dense()

    def providers(self, e: int) -> np.ndarray:
        """S̄(E) — indices of the sources providing the value of entry ``e``."""
        return self.store.providers(e)

    @classmethod
    def from_dense(cls, V: np.ndarray, entry_item, entry_value, entry_p,
                   entry_score, ebar_start: int, l_counts, items_per_source,
                   chunk_entries: Optional[int] = None) -> "InvertedIndex":
        """Wrap a dense incidence (tests, reorders)."""
        return cls(
            store=CorpusStore.from_dense(V, entry_item, entry_value, entry_p,
                                         entry_score,
                                         chunk_entries=chunk_entries),
            ebar_start=ebar_start, l_counts=l_counts,
            items_per_source=items_per_source)

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
        rebuild. A row-range-sharded capture (``store/shard_starts``) comes
        back as a ``ShardedCorpusStore`` under the same plan."""
        meta = np.asarray(d["index/meta"], np.int64)
        ebar_mask = None
        if int(meta[1]):
            ebar_mask = np.asarray(d["index/ebar_mask"], np.uint8).astype(bool)
        if "store/shard_starts" in d:
            store = ShardedCorpusStore.from_state_dict(d, capacity=row_capacity)
        else:
            store = CorpusStore.from_state_dict(d, capacity=row_capacity)
        return cls(
            store=store,
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


def entry_extreme_accuracies(
    V, acc: np.ndarray, chunk: int = 4096
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-entry (min, second-min, max) provider accuracies from the
    incidence: a ``CorpusStore`` or its sharded facade (its nonzero cells,
    chunk by chunk) or a dense array (``chunk`` entries at a time), to
    bound peak memory. An
    entry with one provider gets its minimum as its second minimum; one
    without providers gets (inf, inf, −inf)."""
    if isinstance(V, (CorpusStore, ShardedCorpusStore)):
        return _store_extreme_accuracies(V, acc)
    E = V.shape[1]
    a_min = np.empty(E, np.float64)
    a_second = np.empty(E, np.float64)
    a_max = np.empty(E, np.float64)
    for s0 in range(0, E, chunk):
        member = V[:, s0: s0 + chunk].astype(bool).T       # (w, S)
        a = np.where(member, acc[None, :], np.inf)
        sl = slice(s0, s0 + member.shape[0])
        a_min[sl] = a.min(axis=1)
        a[np.arange(len(a)), np.argmin(a, axis=1)] = np.inf
        a_second[sl] = a.min(axis=1)
        a_max[sl] = np.where(member, acc[None, :], -np.inf).max(axis=1)
    a_second = np.where(np.isfinite(a_second), a_second, a_min)
    return a_min, a_second, a_max


def _store_extreme_accuracies(store: CorpusStore, acc: np.ndarray) -> tuple:
    """``entry_extreme_accuracies`` of a store from its nonzero cells: the
    providers of each column sorted by accuracy, first, second and last —
    the same selections as the dense form, in O(claims) instead of O(S·E)."""
    E = store.n_entries
    a_min = np.full(E, np.inf)
    a_second = np.full(E, np.inf)
    a_max = np.full(E, -np.inf)
    for ch in store.iter_chunks():
        rows, cols = _nonzero_2d(np.ascontiguousarray(ch.V))
        if not len(rows):
            continue
        a = acc[rows]
        order = np.lexsort((a, cols))
        cols, a = cols[order], a[order]
        first = np.flatnonzero(np.r_[True, cols[1:] != cols[:-1]])
        last = np.r_[first[1:], len(cols)] - 1
        col = ch.start + cols[first]
        a_min[col] = a[first]
        a_second[col] = a[np.minimum(first + 1, last)]
        a_max[col] = a[last]
    return a_min, a_second, a_max


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


# ---------------------------------------------------------------------------
# Live corpus mutation: commit / retract / rollback / compact
# ---------------------------------------------------------------------------

@dataclass
class MutationDelta:
    """The (chunk, row-block) change set of one commit or retraction.

    A COMMIT appends rows ``[from_rows, to_rows)`` and sets bits only in
    those rows of ``touched`` existing entries (monotone: no bit is
    cleared), plus brand-new entry columns from ``new_entry_start`` on
    (those carry bits on old rows too). A RETRACTION compacts rows ≥
    ``row_start`` upward and zeroes the ``gc_entries`` columns.
    ``from_mseq``/``to_mseq`` are the store's membership-state identities
    before and after; ``full=True`` (compaction ran) means the delta cannot
    describe the change. ``DetectionEngine.apply_mask_delta`` feeds it to
    the engine's block-OR mask cache (``core/tilecache.py``).
    """

    kind: str                      # "commit" | "retract"
    from_mseq: int                 # store.mseq before the mutation
    to_mseq: int                   # store.mseq after the mutation
    from_rows: int                 # live rows before
    to_rows: int                   # live rows after
    row_start: int                 # first row whose blocks can change
    touched: np.ndarray            # existing entry ids whose bits changed
    new_entry_start: int = -1      # first appended column (commit; -1 none)
    gc_entries: np.ndarray = None  # deactivated entry ids (retract)
    full: bool = False             # compaction ran — delta insufficient


@dataclass
class CommitInfo:
    """Receipt of one ``commit_rows`` call (stats + the rollback snapshot).

    ``touched_keys`` holds the sorted composite (item, value) keys of every
    claim the committed rows carry: a pair of sources can only share an
    entry this commit touched if one of them claims a key in this set.
    """

    rows: int                      # query rows folded into the corpus
    bits_set: int                  # membership bits set on existing entries
    new_entries: int               # newly-shared values appended as deltas
    touched_entries: int           # existing entries whose providers grew
    delta_chunks_added: int        # chunks appended this commit
    compacted: bool                # deltas folded back into the base?
    epoch: int                     # store epoch after the commit
    touched_keys: np.ndarray       # sorted int64 claim keys of the new rows
    wall_s: float                  # host seconds spent committing
    delta: Optional[MutationDelta] = None
    _snap: StoreSnapshot = field(repr=False, default=None)
    _ebar_start: int = field(repr=False, default=0)
    _ebar_mask: Optional[np.ndarray] = field(repr=False, default=None)
    _l_counts: np.ndarray = field(repr=False, default=None)
    _items_per_source: np.ndarray = field(repr=False, default=None)


@dataclass
class RetractInfo:
    """Receipt of one ``retract_rows`` call. Shares the private rollback
    fields with ``CommitInfo``, so ``rollback_commit`` unwinds either."""

    rows: int                      # sources removed from the corpus
    touched_entries: int           # entries the retracted rows provided
    gc_entries: int                # entries retired (fell below 2 providers)
    rescored_entries: int          # surviving touched entries re-scored
    epoch: int                     # store epoch after the retraction
    wall_s: float                  # host seconds spent retracting
    delta: Optional[MutationDelta] = None
    _snap: StoreSnapshot = field(repr=False, default=None)
    _ebar_start: int = field(repr=False, default=0)
    _ebar_mask: Optional[np.ndarray] = field(repr=False, default=None)
    _l_counts: np.ndarray = field(repr=False, default=None)
    _items_per_source: np.ndarray = field(repr=False, default=None)


def _derive_ebar_mask(store: CorpusStore, theta_ind: float) -> np.ndarray:
    """Ē membership over the merged score metadata, without moving incidence.

    Sorts the live entries by decreasing contribution score (a metadata
    argsort; base and delta columns stay where they are) and marks the
    maximal low-score suffix with Σ max(C, 0) < θ_ind. Restricted to any
    score-sorted subsequence (the base, each commit's delta) the marked set
    is still a suffix. Padding columns are marked in Ē: they carry no
    incidence, so no consumer counts them.
    """
    ids = np.nonzero(store.entry_item >= 0)[0]
    scores = store.entry_score[ids].astype(np.float64)
    order = np.argsort(-scores, kind="stable")
    start = _ebar_boundary(scores[order], theta_ind)
    mask = np.ones(store.n_entries, bool)
    mask[ids[order[:start]]] = False
    return mask


def _extremes_of(acc: np.ndarray, provider_lists: list) -> tuple:
    """(min, second-min, max) provider accuracy per provider list."""
    n = len(provider_lists)
    a_min = np.empty(n, np.float64)
    a_second = np.empty(n, np.float64)
    a_max = np.empty(n, np.float64)
    for i, provs in enumerate(provider_lists):
        a = np.sort(acc[provs])
        a_min[i] = a[0]
        a_second[i] = a[min(1, len(a) - 1)]
        a_max[i] = a[-1]
    return a_min, a_second, a_max


def _rescore(store: CorpusStore, entries: np.ndarray, acc: np.ndarray,
             snap: StoreSnapshot, cfg: CopyConfig) -> None:
    """Re-score ``entries`` from their current providers' extreme
    accuracies (M̂ is a provider-pair maximum), copy-on-write on the score
    array while it is still the snapshot's."""
    if store.entry_score is snap.entry_score:
        store.entry_score = store.entry_score.copy()
        store.epoch += 1
    a_min, a_second, a_max = _extremes_of(
        acc, [store.providers(e) for e in entries])
    store.entry_score[entries] = _entry_scores_vectorized(
        store.entry_p[entries], a_min, a_second, a_max, cfg)


def _count_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a @ b.T`` of two 0/1 provision masks as int32: float64 products of
    0/1 are exact integers below 2⁵³, so this equals the int64 product."""
    return (a.astype(np.float64) @ b.astype(np.float64).T).astype(np.int32)


def commit_rows(
    index: InvertedIndex,
    ds: ClaimsDataset,
    p_claim: np.ndarray,
    cfg: CopyConfig,
    n_new: int,
    *,
    compact: bool = True,
    compact_threshold: float = 0.25,
) -> CommitInfo:
    """Fold the last ``n_new`` rows of ``ds`` into the index, incrementally.

    ``ds``/``p_claim`` are the union claims (corpus rows first, the accepted
    query rows last); the index covers the first ``ds.n_sources − n_new``
    rows. The commit (1) sets the rows' membership bits for every existing
    entry (``store.append_rows``, O(q·E)); (2) appends the (item, value)
    groups the new rows turn into shared values as **delta chunks**,
    score-ordered within the delta; (3) re-scores existing entries whose
    provider set grew; (4) extends ``l_counts``/``items_per_source`` by
    block updates (O(S·q·D), integer-exact); (5) re-derives Ē from the
    merged score metadata as ``ebar_mask``; (6) with ``compact``, folds the
    deltas back into one score-sorted base once their live entries exceed
    ``compact_threshold`` of all live entries. The same steps, in the same
    order, as the JAX package's ``commit_rows``, so both leave equal state.

    Returns a ``CommitInfo``; ``rollback_commit(index, info)`` restores the
    state before the commit, bit-exact.
    """
    t0 = time.perf_counter()
    store = index.store
    S = ds.n_sources
    q = int(n_new)
    S0 = S - q
    if store.n_rows != S0:
        raise ValueError(
            f"commit_rows: index covers {store.n_rows} rows, union has "
            f"{S} with {q} new — expected {S0}")
    snap = store.snapshot()
    from_mseq = store.mseq
    info = CommitInfo(
        rows=q, bits_set=0, new_entries=0, touched_entries=0,
        delta_chunks_added=0, compacted=False, epoch=store.epoch,
        touched_keys=np.zeros(0, np.int64), wall_s=0.0,
        _snap=snap, _ebar_start=index.ebar_start, _ebar_mask=index.ebar_mask,
        _l_counts=index.l_counts, _items_per_source=index.items_per_source)

    new_vals = ds.values[S0:S]
    bits, touched = store.append_rows(new_vals, collect_touched=True)

    # -- 2. newly shared (item, value) groups → delta entries ---------------
    live = store.entry_item >= 0
    existing = np.unique(store.entry_item[live].astype(np.int64)
                         * CLAIM_KEY_BASE + store.entry_value[live])
    new_keys = claim_value_keys(new_vals)
    cand = new_keys[~np.isin(new_keys, existing)]
    # one union-column scan per novel key, O(|cand|·S)
    e_item, e_value, e_p, e_provs = [], [], [], []
    for key in cand:
        d = int(key // CLAIM_KEY_BASE)
        v = int(key % CLAIM_KEY_BASE)
        provs = np.nonzero(ds.values[:, d] == v)[0]
        if len(provs) < 2:
            continue                      # still a singleton in the union
        e_item.append(d)
        e_value.append(v)
        e_p.append(float(p_claim[provs[0], d]))
        e_provs.append(provs)
    n_newe = len(e_item)
    # taken before append_entries, so the padding columns that
    # _pad_last_chunk_full adds count as new (zero incidence)
    new_entry_start = store.n_entries if n_newe else -1
    if n_newe:
        a_min, a_second, a_max = _extremes_of(ds.accuracy.astype(np.float64),
                                              e_provs)
        p_arr = np.asarray(e_p, np.float64)
        scores = _entry_scores_vectorized(p_arr.astype(np.float32),
                                          a_min, a_second, a_max, cfg)
        order = np.argsort(-scores, kind="stable")
        cols = np.zeros((S, n_newe), np.int8)
        for j, src in enumerate(order):
            cols[e_provs[src], j] = 1
        info.delta_chunks_added = store.append_entries(
            cols,
            np.asarray(e_item, np.int32)[order],
            np.asarray(e_value, np.int32)[order],
            p_arr.astype(np.float32)[order],
            scores[order])
        info.new_entries = n_newe

    # -- 3. re-score entries whose provider set grew ------------------------
    if len(touched):
        _rescore(store, touched, ds.accuracy.astype(np.float64), snap, cfg)
        info.touched_entries = len(touched)

    # -- 4. block updates of the pair/source aggregates ---------------------
    if q:
        prov = ds.provided_mask
        cross = _count_product(prov[:S0], prov[S0:])
        l_new = np.zeros((S, S), np.int32)
        l_new[:S0, :S0] = index.l_counts
        l_new[:S0, S0:] = cross
        l_new[S0:, :S0] = cross.T
        l_new[S0:, S0:] = _count_product(prov[S0:], prov[S0:])
        index.l_counts = l_new
        index.items_per_source = np.concatenate(
            [index.items_per_source, prov[S0:].sum(axis=1).astype(np.int32)])

    # -- 5. Ē from the merged score metadata --------------------------------
    index.ebar_mask = _derive_ebar_mask(store, cfg.theta_ind)

    # -- 6. compaction ------------------------------------------------------
    if compact and store.delta_start is not None:
        n_live = store.n_live_entries
        if n_live and store.n_delta_entries > compact_threshold * n_live:
            compact_index(index, cfg)
            info.compacted = True

    info.bits_set = bits
    info.epoch = index.store.epoch
    info.touched_keys = new_keys
    info.delta = MutationDelta(
        kind="commit", from_mseq=from_mseq, to_mseq=index.store.mseq,
        from_rows=S0, to_rows=index.store.n_rows, row_start=S0,
        touched=touched, new_entry_start=new_entry_start,
        gc_entries=np.zeros(0, np.int64), full=info.compacted)
    info.wall_s = time.perf_counter() - t0
    return info


def retract_rows(
    index: InvertedIndex,
    ds_after: ClaimsDataset,
    cfg: CopyConfig,
    row_ids: np.ndarray,
) -> RetractInfo:
    """Drop committed sources from the index — the inverse of ``commit_rows``.

    ``ds_after`` is the claims dataset after the retraction (the surviving
    rows, in order); ``row_ids`` are the retracted rows' indices before it.
    The retraction (1) finds the entries the retracted rows provided; (2)
    removes the rows (``store.retract_rows``; the chunk arrays are replaced,
    so the snapshot stays valid); (3) retires touched entries left with
    fewer than two providers as inert padding — exactly the entries a
    rebuild over ``ds_after`` would not index; (4) re-scores the surviving
    touched entries; (5) shrinks ``l_counts``/``items_per_source``; (6)
    re-derives Ē as ``ebar_mask``. ``rollback_commit(index, info)`` restores
    the state before it, bit-exact.
    """
    t0 = time.perf_counter()
    store = index.store
    row_ids = np.unique(np.asarray(row_ids, np.int64))
    k = len(row_ids)
    S0 = store.n_rows
    if ds_after.n_sources != S0 - k:
        raise ValueError(
            f"retract_rows: index covers {S0} rows, {k} retracted — "
            f"ds_after must have {S0 - k} rows, got {ds_after.n_sources}")
    snap = store.snapshot()
    from_mseq = store.mseq
    info = RetractInfo(
        rows=k, touched_entries=0, gc_entries=0, rescored_entries=0,
        epoch=store.epoch, wall_s=0.0,
        _snap=snap, _ebar_start=index.ebar_start, _ebar_mask=index.ebar_mask,
        _l_counts=index.l_counts, _items_per_source=index.items_per_source)
    if k == 0:
        info.wall_s = time.perf_counter() - t0
        return info

    # -- 1. entries the retracted rows provided -----------------------------
    touched = [ch.start + np.nonzero(ch.V[row_ids].any(axis=0))[0]
               for ch in store.iter_chunks()]
    touched = np.concatenate(touched) if touched else np.zeros(0, np.int64)
    info.touched_entries = len(touched)

    # -- 2. remove the rows -------------------------------------------------
    store.retract_rows(row_ids)

    # -- 3. retire entries that stopped being shared; 4. re-score the rest --
    gc_ids = np.zeros(0, np.int64)
    if len(touched):
        counts = np.array([int(store.column(e).sum()) for e in touched])
        gc_ids = touched[counts < 2]
        survivors = touched[counts >= 2]
        store.deactivate_entries(gc_ids)
        info.gc_entries = len(gc_ids)
        if len(survivors):
            _rescore(store, survivors, ds_after.accuracy.astype(np.float64),
                     snap, cfg)
            info.rescored_entries = len(survivors)

    # -- 5. shrink the pair/source aggregates -------------------------------
    index.l_counts = np.delete(
        np.delete(index.l_counts, row_ids, axis=0), row_ids, axis=1)
    index.items_per_source = np.delete(index.items_per_source, row_ids)

    # -- 6. Ē from the surviving score metadata -----------------------------
    index.ebar_mask = _derive_ebar_mask(store, cfg.theta_ind)

    info.epoch = store.epoch
    info.delta = MutationDelta(
        kind="retract", from_mseq=from_mseq, to_mseq=store.mseq,
        from_rows=S0, to_rows=store.n_rows, row_start=int(row_ids[0]),
        touched=touched, new_entry_start=-1, gc_entries=gc_ids, full=False)
    info.wall_s = time.perf_counter() - t0
    return info


def rollback_commit(index: InvertedIndex, info) -> None:
    """Restore the index to its state before the mutation ``info`` records
    (a ``CommitInfo`` or a ``RetractInfo``), bit-exact. Valid for the last
    mutation applied — mutations unwind LIFO — and across a compaction: the
    snapshot holds the pre-mutation store object, which no mutation writes
    in place."""
    info._snap.restore()
    index.store = info._snap.store
    index.ebar_start = info._ebar_start
    index.ebar_mask = info._ebar_mask
    index.l_counts = info._l_counts
    index.items_per_source = info._items_per_source


def compact_index(index: InvertedIndex, cfg: CopyConfig) -> None:
    """Fold delta chunks back into one score-sorted base.

    Gathers the live entries in decreasing-score order into a fresh
    uniform-chunk store, drops the padding columns, and restores the prefix
    Ē (``ebar_mask`` back to ``None``). O(S·E) — amortized by
    ``commit_rows``' ``compact_threshold``.
    """
    store = index.store
    live_ids = np.nonzero(store.entry_item >= 0)[0]
    order = live_ids[np.argsort(-store.entry_score[live_ids], kind="stable")]
    new_store = store.gather_entries(order, chunk_entries=store.chunk_entries,
                                     capacity=store.capacity)
    new_store.epoch = store.epoch + 1
    index.ebar_start = _ebar_boundary(new_store.entry_score, cfg.theta_ind)
    index.ebar_mask = None
    index.store = new_store


def canonicalized(index: InvertedIndex, cfg: CopyConfig) -> InvertedIndex:
    """A score-sorted, prefix-Ē view of a committed index (a gathered copy;
    ``index`` itself is returned when it is already canonical and is never
    mutated)."""
    if index.ebar_mask is None:
        return index
    view = InvertedIndex(store=index.store, ebar_start=index.ebar_start,
                         l_counts=index.l_counts,
                         items_per_source=index.items_per_source,
                         ebar_mask=index.ebar_mask)
    compact_index(view, cfg)          # mutates only the shallow view
    return view


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
class BucketedIndex:
    """Score-ordered index partitioned into K contiguous buckets.

    Bucket k covers entry columns [starts[k], starts[k+1]), all approximated
    with one representative truth probability p̂_k (geometric mean).
    m_suffix[k] = max entry score at or after bucket k.
    """

    index: InvertedIndex
    starts: np.ndarray        # (K+1,) int32
    p_hat: np.ndarray         # (K,) float32
    m_suffix: np.ndarray      # (K+1,) float32; m_suffix[K] = 0
    ebar_bucket: int          # first bucket that lies fully inside Ē
    p_lo: Optional[np.ndarray] = None  # (K,) min live p per bucket
    p_hi: Optional[np.ndarray] = None  # (K,) max live p per bucket

    @property
    def n_buckets(self) -> int:
        """K — number of contiguous entry buckets."""
        return len(self.p_hat)


def _suffix_max(scores: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """(K+1,) float32 — the maximum score at or after each bucket."""
    K = len(bounds) - 1
    m_suffix = np.zeros(K + 1, np.float32)
    for k in range(K - 1, -1, -1):
        blk_max = float(scores[bounds[k]: bounds[k + 1]].max())
        m_suffix[k] = max(blk_max, m_suffix[k + 1])
    return m_suffix


def bucketize(index: InvertedIndex, n_buckets: int = 64) -> BucketedIndex:
    """Partition the entries, in their physical order, into ~equal
    contiguous buckets (the BYCONTRIBUTION scan at a coarser grain).

    A fresh index's Ē boundary is pinned as a bucket boundary. A committed
    index (delta chunks, ``ebar_mask``) buckets its physical order instead:
    ``m_suffix`` is the true suffix max (exact for any order), p̂ averages
    only live columns, and ``ebar_bucket`` is the first bucket from which
    every later bucket lies fully inside Ē.
    """
    E = index.n_entries
    if E == 0:
        return BucketedIndex(index, np.zeros(1, np.int32),
                             np.zeros(0, np.float32), np.zeros(1, np.float32), 0)
    K = min(n_buckets, E)
    live = index.live_mask
    bounds = np.unique(np.linspace(0, E, K + 1).round().astype(np.int32))
    if (index.ebar_mask is None and 0 < index.ebar_start < E
            and index.ebar_start not in bounds):
        bounds = np.sort(np.unique(np.append(bounds, index.ebar_start)))
    p_hat, p_lo, p_hi = _segment_p_stats(index.entry_p, live, bounds)
    K = len(bounds) - 1
    m_suffix = _suffix_max(index.entry_score, bounds)
    if index.ebar_mask is None:
        ebar_bucket = int(np.searchsorted(bounds, index.ebar_start))
    else:
        nonebar = index.nonebar_mask
        ebar_bucket = K
        for k in range(K - 1, -1, -1):
            if nonebar[bounds[k]: bounds[k + 1]].any():
                break
            ebar_bucket = k
    return BucketedIndex(index=index, starts=bounds, p_hat=p_hat,
                         m_suffix=m_suffix, ebar_bucket=ebar_bucket,
                         p_lo=p_lo, p_hi=p_hi)


def bucketize_engine(
    index: InvertedIndex, n_buckets: int = 64
) -> tuple[BucketedIndex, np.ndarray, np.ndarray]:
    """p-homogeneous bucketization over a reordered copy of a fresh
    (prefix-Ē) index: entries sorted by p within the non-Ē prefix and
    within Ē, buckets proportional to the two regions with a boundary
    pinned at the Ē start. The legacy form the per-tile copyscore
    baseline reads (``engine_chunks`` is the engine's).

    Returns (bucketed, p_lo, p_hi): the ``BucketedIndex`` plus per-bucket
    p extremes for the rescore bound.
    """
    E = index.n_entries
    e0 = index.ebar_start
    if E == 0:
        return (bucketize(index, n_buckets), np.zeros(0, np.float32),
                np.zeros(0, np.float32))
    order = np.concatenate([
        np.argsort(index.entry_p[:e0], kind="stable"),
        e0 + np.argsort(index.entry_p[e0:], kind="stable"),
    ])
    idx2 = InvertedIndex(store=index.store.gather_entries(order),
                         ebar_start=e0, l_counts=index.l_counts,
                         items_per_source=index.items_per_source)
    k_out = min(max(int(round(n_buckets * e0 / E)), 1), e0) if e0 else 0
    k_in = min(max(n_buckets - k_out, 1), E - e0) if E > e0 else 0
    bounds = np.unique(np.concatenate([
        np.linspace(0, e0, k_out + 1).round(),
        np.linspace(e0, E, k_in + 1).round(),
    ])).astype(np.int32)
    K = len(bounds) - 1
    logp = np.log(np.clip(idx2.entry_p, 1e-9, 1.0))
    p_hat = np.empty(K, np.float32)
    p_lo = np.empty(K, np.float32)
    p_hi = np.empty(K, np.float32)
    for k in range(K):
        seg = slice(bounds[k], bounds[k + 1])
        p_hat[k] = float(np.exp(logp[seg].mean()))
        p_lo[k] = float(idx2.entry_p[seg].min())
        p_hi[k] = float(idx2.entry_p[seg].max())
    ebar_bucket = int(np.searchsorted(bounds, e0))
    return (BucketedIndex(index=idx2, starts=bounds, p_hat=p_hat,
                          m_suffix=_suffix_max(idx2.entry_score, bounds),
                          ebar_bucket=ebar_bucket),
            p_lo, p_hi)


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
    seal: Optional[dict] = None,
) -> EngineChunks:
    """Build the engine's uniform-width chunk store from an index.

    The chunk width is ``ceil(E / n_buckets)`` aligned up to 8, so
    ``n_buckets`` keeps its meaning as the p̂ granularity; the Ē boundary
    is chunk-aligned by construction (each region is padded with inert zero
    columns), which keeps the kernel's per-chunk non-Ē channel exact.
    ``max_width`` caps the chunk width from above (the engine derives it
    from its per-pass byte budget). ``seal`` (``pack`` / ``spill_dir`` /
    ``resident_bytes``) streams a seal through the gather of a sharded
    index store (``ShardedCorpusStore.gather_entries``).
    """
    kw = seal if seal and isinstance(index.store, ShardedCorpusStore) else {}
    nonebar = index.nonebar_mask
    live = index.live_mask
    non = np.nonzero(nonebar)[0]
    ebar = np.nonzero(live & ~nonebar)[0]
    n_live = len(non) + len(ebar)
    cap = index.n_sources if row_capacity is None else int(row_capacity)
    if n_live == 0:
        empty = index.store.gather_entries(np.zeros(0, np.int64), capacity=cap,
                                           **kw)
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
                                       capacity=cap, **kw)
    K = store.n_chunks
    ebar_chunk = (len(non) + pad0) // b

    p_hat, p_lo, p_hi = _segment_p_stats(
        store.entry_p, store.entry_item >= 0, np.arange(K + 1) * b)
    nout = (np.arange(K) < ebar_chunk).astype(np.float32)
    return EngineChunks(store=store, p_hat=p_hat, p_lo=p_lo, p_hi=p_hi,
                        nout=nout, ebar_chunk=ebar_chunk, n_live=n_live,
                        order=order)


__all__ = ["BucketedIndex", "CommitInfo", "EngineChunks", "InvertedIndex",
           "MutationDelta", "RetractInfo", "bucketize", "bucketize_engine",
           "build_index", "canonicalized", "commit_rows", "compact_index",
           "engine_chunks", "entry_contribution_score",
           "entry_extreme_accuracies", "pair_item_counts",
           "prop31_reference_accs", "retract_rows", "rollback_commit"]
