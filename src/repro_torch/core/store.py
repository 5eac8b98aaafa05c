"""CorpusStore — the entry-chunked incidence store.

The inverted index's source×entry incidence matrix V lives as
**entry-chunked blocks**: dense int8 arrays of ``(capacity, chunk_entries)``,
the chunk width a multiple of 8 so chunks feed the copyscore kernel without
relayout. Per-chunk entry metadata (item, value id, truth probability,
contribution score) rides along as views of the store's entry arrays.

``build_index`` streams claims into chunks without ever allocating the
``(S, E)`` incidence whole; the engine gathers its p-ordered chunk store
from it and ships one chunk (group) at a time to the device. The layout and
``state_dict`` keys are those of the JAX package's ``CorpusStore``, so an
index captured there loads here bit-exactly.

Mutation is append-commit-compact, as in the JAX package: ``append_rows``
/ ``truncate_rows`` stage query rows in the row slack; ``append_entries``
grows the entry axis with **delta chunks** (the last resident chunk is
padded to full width with inert columns first, so the uniform
``chunk_start`` addressing survives); ``retract_rows`` and
``deactivate_entries`` remove sources and retire entries. No mutation
writes a captured array in place, so ``snapshot()`` is a list of array
references and ``StoreSnapshot.restore`` is bit-exact. ``epoch`` counts
structural mutations, and chunk handles are memoized per ``(epoch,
n_rows)``; ``mseq`` names one membership state for the life of the
process.

Bitpacked membership (``PackedBlock``, ``pack_membership``,
``unpack_membership``, ``packed_count_matmul``) is the row-range shard
plane's 1-bit resident form (``core/shardplan.py``): plain numpy, as in the
JAX package, which computes it outside any kernel.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

#: Default entry-chunk width (columns), a multiple of the tile-edge alignment.
DEFAULT_CHUNK_ENTRIES = 512

#: Chunk-layout version for serialized stores (``state_dict``); loaders
#: reject state dicts from a newer version.
STORE_LAYOUT_VERSION = 1


def align_chunk(width: int) -> int:
    """Round a requested chunk width up to the kernel tile-edge multiple (8)."""
    return max(8, -(-int(width) // 8) * 8)


#: Global monotonic mutation-sequence source. Every store mutation, and
#: every snapshot restore, draws a fresh value, so ``(store identity, mseq)``
#: names one membership state for the life of the process: no rollback can
#: bring back a previously seen mseq with different bits.
_MSEQ = itertools.count(1)


def next_mseq() -> int:
    """Draw the next globally unique mutation-sequence number."""
    return next(_MSEQ)


@dataclass
class ChunkView:
    """One chunk handle: live incidence rows + its entry-metadata views."""

    start: int                 # global index of this chunk's first entry
    V: np.ndarray              # (n_rows, width) int8 incidence (a view)
    item: np.ndarray           # (width,) int32 — D_E (−1 for padding columns)
    value: np.ndarray          # (width,) int32 — v_E (−1 for padding columns)
    p: np.ndarray              # (width,) float32 — P(E)
    score: np.ndarray          # (width,) float32 — C(E)

    @property
    def width(self) -> int:
        """Number of entry columns in this chunk."""
        return self.V.shape[1]


@dataclass
class CorpusStore:
    """Entry-chunked incidence + metadata; rows have slack capacity.

    Invariants: every chunk except the last is exactly ``chunk_entries``
    wide (a multiple of 8); chunk row dimension is ``capacity`` with rows
    ``[n_rows:]`` zero. Columns may be inert padding (``entry_item == -1``,
    all-zero incidence) — they contribute nothing to any co-occurrence
    count, so every consumer can ignore them.
    """

    chunks: list = field(default_factory=list)   # list[np.ndarray] (capacity, w)
    entry_item: np.ndarray = None                # (E,) int32
    entry_value: np.ndarray = None               # (E,) int32
    entry_p: np.ndarray = None                   # (E,) float32
    entry_score: np.ndarray = None               # (E,) float32
    chunk_entries: int = DEFAULT_CHUNK_ENTRIES
    n_rows: int = 0
    capacity: int = 0
    delta_start: Optional[int] = None            # first delta entry; None = no deltas
    epoch: int = 0                               # structural-mutation count

    def __post_init__(self):
        if self.entry_item is None:
            self.entry_item = np.zeros(0, np.int32)
        if self.entry_value is None:
            self.entry_value = np.zeros(0, np.int32)
        if self.entry_p is None:
            self.entry_p = np.zeros(0, np.float32)
        if self.entry_score is None:
            self.entry_score = np.zeros(0, np.float32)
        if self.capacity < self.n_rows:
            self.capacity = self.n_rows
        # per-(epoch, n_rows) memo of ChunkView handles
        self._views: dict = {}
        self._views_key = None
        # membership-state identity; not a field and not serialized
        self.mseq = next_mseq()

    # -- geometry -----------------------------------------------------------

    @property
    def n_entries(self) -> int:
        """E — total entry columns across chunks (padding included)."""
        return len(self.entry_item)

    @property
    def n_chunks(self) -> int:
        """Number of entry chunks."""
        return len(self.chunks)

    def release_chunk(self, c: int) -> None:
        """Free chunk ``c``'s incidence block, irreversibly: any later read
        of it raises instead of returning stale or zero incidence."""
        self.chunks[int(c)] = None
        self._views = {}
        self._views_key = None

    @property
    def n_live_entries(self) -> int:
        """Entries that are real (non-padding) columns."""
        return int(np.count_nonzero(self.entry_item >= 0))

    @property
    def n_delta_entries(self) -> int:
        """Live entries in the delta region (appended since the last base)."""
        if self.delta_start is None:
            return 0
        return int(np.count_nonzero(self.entry_item[self.delta_start:] >= 0))

    @property
    def n_delta_chunks(self) -> int:
        """Chunks that hold at least one delta entry."""
        if self.delta_start is None:
            return 0
        return self.n_chunks - self.delta_start // self.chunk_entries

    def chunk_start(self, c: int) -> int:
        """Global index of chunk ``c``'s first entry column."""
        return c * self.chunk_entries

    def chunk_width(self, c: int) -> int:
        """Column count of chunk ``c``."""
        return self.chunks[c].shape[1]

    def chunk(self, c: int) -> ChunkView:
        """Chunk ``c`` as a handle: live rows + metadata views (zero copy).

        Handles are memoized per ``(epoch, n_rows)``: within one epoch the
        same ``ChunkView`` object comes back on every access. Structural
        mutations bump ``epoch`` and row staging changes ``n_rows``; either
        drops the memo.
        """
        key = (self.epoch, self.n_rows)
        if self._views_key != key:
            self._views = {}
            self._views_key = key
        view = self._views.get(c)
        if view is None:
            if self.chunks[c] is None:
                raise RuntimeError(f"chunk {c} was released (release_chunk)")
            s0 = self.chunk_start(c)
            s1 = s0 + self.chunks[c].shape[1]
            view = ChunkView(start=s0, V=self.chunks[c][: self.n_rows],
                             item=self.entry_item[s0:s1],
                             value=self.entry_value[s0:s1],
                             p=self.entry_p[s0:s1],
                             score=self.entry_score[s0:s1])
            self._views[c] = view
        return view

    def iter_chunks(self) -> Iterator[ChunkView]:
        """Iterate chunk handles in entry order."""
        for c in range(self.n_chunks):
            yield self.chunk(c)

    # -- column access ------------------------------------------------------

    def column(self, e: int) -> np.ndarray:
        """Incidence column of entry ``e`` over live rows (a view)."""
        c, off = divmod(int(e), self.chunk_entries)
        return self.chunks[c][: self.n_rows, off]

    def providers(self, e: int) -> np.ndarray:
        """S̄(E) — indices of the sources providing entry ``e``'s value."""
        return np.nonzero(self.column(e))[0]

    def slice_entries(self, e0: int, e1: int, dtype=np.int8,
                      rows: Optional[int] = None) -> np.ndarray:
        """Dense ``(rows, e1 − e0)`` copy of an entry range across chunks.

        Meant for narrow ranges (one bucket, one kernel block): the result
        is a fresh allocation of exactly the requested width. ``rows``
        defaults to the live rows; rows past them read zero.
        """
        e0, e1 = int(e0), int(e1)
        n = self.n_rows if rows is None else int(rows)
        out = np.zeros((n, e1 - e0), dtype=dtype)
        w = self.chunk_entries
        live = min(n, self.n_rows)
        for c in range(e0 // w if w else 0, self.n_chunks):
            s0 = self.chunk_start(c)
            if s0 >= e1:
                break
            s1 = s0 + self.chunks[c].shape[1]
            lo, hi = max(e0, s0), min(e1, s1)
            if lo < hi:
                out[:live, lo - e0: hi - e0] = \
                    self.chunks[c][:live, lo - s0: hi - s0]
        return out

    def to_dense(self) -> np.ndarray:
        """The full ``(n_rows, E)`` incidence — compat/debug accessor ONLY.

        Production code streams chunks instead. With a single chunk this is
        a zero-copy view.
        """
        if self.n_chunks == 1:
            return self.chunks[0][: self.n_rows]
        if self.n_chunks == 0:
            return np.zeros((self.n_rows, 0), np.int8)
        return np.concatenate(
            [c[: self.n_rows] for c in self.chunks], axis=1)

    def cooccurrence(self, stop: Optional[int] = None, dtype=np.float32,
                     mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Pair co-occurrence counts Σ_e V[i,e]·V[j,e] over selected entries.

        ``stop`` keeps the prefix ``[:stop]``; ``mask`` (an (E,) bool array)
        keeps an arbitrary entry subset instead (the form Ē takes once delta
        chunks make it a mask). Accumulated chunk by chunk; 0/1 products in
        float32 are exact integers below 2²⁴, so the result is bit-equal to
        the dense product for any chunking.
        """
        S = self.n_rows
        out = np.zeros((S, S), dtype)
        stop = self.n_entries if stop is None else int(stop)
        for ch in self.iter_chunks():
            if mask is not None:
                m = mask[ch.start: ch.start + ch.width]
                if not m.any():
                    continue
                v = (ch.V if m.all() else ch.V[:, m]).astype(dtype)
            elif ch.start >= stop:
                break
            else:
                v = ch.V[:, : min(ch.width, stop - ch.start)].astype(dtype)
            out += v @ v.T
        return out

    # -- derived stores -----------------------------------------------------

    def gather_entries(self, order: np.ndarray,
                       chunk_entries: Optional[int] = None,
                       capacity: Optional[int] = None) -> "CorpusStore":
        """A new store whose column ``j`` is this store's column ``order[j]``.

        ``order`` may contain ``-1`` markers for inert zero-padding columns
        (the engine uses them to align region boundaries to chunk edges);
        a live column may appear at most once. The result equals the JAX
        package's column-by-column gather. It is built from the incidence's
        nonzeros instead: each source chunk is scanned once and its set bits
        are scattered to their new columns, so the cost follows the claims,
        not the (S, E) area twice over. Neither incidence is materialized
        whole.
        """
        order = np.asarray(order, np.int64)
        E_out = len(order)
        w = self.chunk_entries if chunk_entries is None else align_chunk(chunk_entries)
        cap = self.capacity if capacity is None else max(int(capacity), self.n_rows)
        live = order >= 0
        src = order[live]
        dst_of = np.full(self.n_entries, -1, np.int64)
        dst_of[src] = np.nonzero(live)[0]
        if np.count_nonzero(dst_of >= 0) != len(src):
            raise ValueError("gather_entries: order repeats a live column")

        item = np.full(E_out, -1, np.int32)
        value = np.full(E_out, -1, np.int32)
        p = np.zeros(E_out, np.float32)
        score = np.zeros(E_out, np.float32)
        item[live] = self.entry_item[src]
        value[live] = self.entry_value[src]
        p[live] = self.entry_p[src]
        score[live] = self.entry_score[src]

        chunks = [np.zeros((cap, min(w, E_out - j0)), np.int8)
                  for j0 in range(0, E_out, max(w, 1))]
        rows_all, dst_all, val_all = [], [], []
        for c, blk in enumerate(self.chunks):
            rows, cols = _nonzero_2d(blk[: self.n_rows])
            dst = dst_of[self.chunk_start(c) + cols]
            keep = dst >= 0
            rows_all.append(rows[keep])
            dst_all.append(dst[keep])
            val_all.append(blk[rows[keep], cols[keep]])
        if chunks and rows_all:
            rows = np.concatenate(rows_all)
            dst = np.concatenate(dst_all)
            vals = np.concatenate(val_all)
            by_chunk = np.argsort(dst // w, kind="stable")
            rows, dst, vals = rows[by_chunk], dst[by_chunk], vals[by_chunk]
            bounds = np.searchsorted(dst, np.arange(len(chunks) + 1) * w)
            for oc, blk in enumerate(chunks):
                lo, hi = bounds[oc], bounds[oc + 1]
                blk[rows[lo:hi], dst[lo:hi] - oc * w] = vals[lo:hi]
        return CorpusStore(chunks=chunks, entry_item=item, entry_value=value,
                           entry_p=p, entry_score=score, chunk_entries=w,
                           n_rows=self.n_rows, capacity=cap)

    # -- row mutation -------------------------------------------------------

    def append_rows(self, values_rows: np.ndarray,
                    collect_touched: bool = False):
        """Write incidence rows for new sources into the slack capacity.

        ``values_rows`` is ``(q, D)`` int32 in the corpus's value coding. For
        every existing entry (D_E, v_E) a new row's membership bit is set
        where its claim matches: one ``(q, width)`` comparison per chunk, so
        the cost is O(q·E), independent of the corpus rows. Values the new
        rows share only with each other (or that turn a singleton into a
        shared value) are not entries yet: ``index.commit_rows`` appends
        them as delta chunks, and needs the entries whose provider set grew
        — ``collect_touched=True`` returns ``(bits, touched_entry_ids)``
        instead of the bare bit count.
        """
        values_rows = np.asarray(values_rows, np.int32)
        q = values_rows.shape[0]
        if self.n_rows + q > self.capacity:
            raise ValueError(
                f"append_rows: {q} rows exceed capacity "
                f"({self.n_rows}/{self.capacity} used)")
        bits = 0
        touched = []
        for c in range(self.n_chunks):
            s0 = self.chunk_start(c)
            s1 = s0 + self.chunks[c].shape[1]
            it = self.entry_item[s0:s1]
            va = self.entry_value[s0:s1]
            ok = it >= 0
            hit = np.zeros((q, s1 - s0), np.int8)
            if ok.any() and q:
                hit[:, ok] = (values_rows[:, it[ok]] == va[ok][None, :]
                              ).astype(np.int8)
            self.chunks[c][self.n_rows: self.n_rows + q] = hit
            bits += int(hit.sum())
            if collect_touched:
                touched.append(s0 + np.nonzero(hit.any(axis=0))[0])
        self.n_rows += q
        self.mseq = next_mseq()
        if collect_touched:
            return bits, (np.concatenate(touched) if touched
                          else np.zeros(0, np.int64))
        return bits

    def truncate_rows(self, n_rows: int) -> None:
        """Drop appended rows back down to ``n_rows`` (zeroing their slack)."""
        n_rows = int(n_rows)
        if n_rows > self.n_rows:
            raise ValueError(f"truncate_rows({n_rows}) above n_rows={self.n_rows}")
        for c in self.chunks:
            c[n_rows: self.n_rows] = 0
        self.n_rows = n_rows
        self.mseq = next_mseq()

    def retract_rows(self, row_ids: np.ndarray) -> None:
        """Remove arbitrary live rows (source retraction).

        Every chunk is replaced by a fresh array holding the surviving rows
        compacted upward, so the row axis stays dense and ``n_rows`` drops
        by the number of distinct ids; capacity is kept. The old chunk
        arrays are never written, so a snapshot taken before stays valid.
        Bumps ``epoch``. Entries left with fewer than two providers are the
        caller's to retire (``index.retract_rows``).
        """
        row_ids = np.unique(np.asarray(row_ids, np.int64))
        if len(row_ids) == 0:
            return
        if row_ids[0] < 0 or row_ids[-1] >= self.n_rows:
            raise ValueError(
                f"retract_rows: ids out of range [0, {self.n_rows})")
        keep = np.ones(self.n_rows, bool)
        keep[row_ids] = False
        n_keep = int(keep.sum())
        for c in range(self.n_chunks):
            blk = np.zeros((self.capacity, self.chunks[c].shape[1]), np.int8)
            blk[:n_keep] = self.chunks[c][: self.n_rows][keep]
            self.chunks[c] = blk
        self.n_rows = n_keep
        self.epoch += 1
        self.mseq = next_mseq()

    def deactivate_entries(self, entry_ids: np.ndarray) -> None:
        """Turn entry columns into inert padding (retraction's GC).

        An entry left with fewer than two providers is no longer a shared
        value (Def. 3.2) and leaves the index as a rebuild would drop it:
        its incidence is zeroed and its metadata set to the padding
        convention (item/value −1, p/score 0). Copy-on-write on the affected
        chunks and the metadata arrays, so a snapshot taken before stays
        valid. Bumps ``epoch``.
        """
        entry_ids = np.asarray(entry_ids, np.int64)
        if len(entry_ids) == 0:
            return
        w = self.chunk_entries
        for cid in np.unique(entry_ids // w):
            cols = entry_ids[entry_ids // w == cid] - cid * w
            blk = self.chunks[cid].copy()
            blk[:, cols] = 0
            self.chunks[int(cid)] = blk
        item = self.entry_item.copy()
        value = self.entry_value.copy()
        p = self.entry_p.copy()
        score = self.entry_score.copy()
        item[entry_ids] = -1
        value[entry_ids] = -1
        p[entry_ids] = 0.0
        score[entry_ids] = 0.0
        self.entry_item, self.entry_value = item, value
        self.entry_p, self.entry_score = p, score
        self.epoch += 1
        self.mseq = next_mseq()

    # -- entry mutation (delta chunks) ---------------------------------------

    def _pad_last_chunk_full(self) -> None:
        """Pad the trailing chunk to the uniform width with inert columns,
        so ``chunk_start(c) = c·chunk_entries`` stays valid once delta
        chunks follow a partial base chunk. A padded copy replaces the
        chunk array, which is not written, so a snapshot stays bit-exact."""
        if not self.chunks:
            return
        last = self.chunks[-1]
        w = last.shape[1]
        if w == self.chunk_entries:
            return
        pad = self.chunk_entries - w
        blk = np.zeros((last.shape[0], self.chunk_entries), np.int8)
        blk[:, :w] = last
        self.chunks[-1] = blk
        self.entry_item = np.concatenate(
            [self.entry_item, np.full(pad, -1, np.int32)])
        self.entry_value = np.concatenate(
            [self.entry_value, np.full(pad, -1, np.int32)])
        self.entry_p = np.concatenate(
            [self.entry_p, np.zeros(pad, np.float32)])
        self.entry_score = np.concatenate(
            [self.entry_score, np.zeros(pad, np.float32)])

    def append_entries(self, cols: np.ndarray, item, value, p, score) -> int:
        """Append new entry columns as delta chunks.

        ``cols`` is ``(n_rows, n_new)`` int8 incidence over the live rows,
        ordered by decreasing contribution score (the within-delta
        BYCONTRIBUTION order). The last resident chunk is first padded to
        the uniform width with inert columns; the new columns land in fresh
        ``(capacity, chunk_entries)`` blocks, and the resident incidence is
        never re-sorted or re-copied. Returns the number of delta chunks
        added. Bumps ``epoch``.
        """
        cols = np.asarray(cols, np.int8)
        n_new = cols.shape[1]
        if n_new == 0:
            return 0
        if cols.shape[0] != self.n_rows:
            raise ValueError(
                f"append_entries: {cols.shape[0]} rows, store has {self.n_rows}")
        self._pad_last_chunk_full()
        if self.delta_start is None:
            self.delta_start = self.n_entries
        w = self.chunk_entries
        added = 0
        for j0 in range(0, n_new, w):
            width = min(w, n_new - j0)
            blk = np.zeros((self.capacity, width), np.int8)
            blk[: self.n_rows] = cols[:, j0: j0 + width]
            self.chunks.append(blk)
            added += 1
        self.entry_item = np.concatenate(
            [self.entry_item, np.asarray(item, np.int32)])
        self.entry_value = np.concatenate(
            [self.entry_value, np.asarray(value, np.int32)])
        self.entry_p = np.concatenate(
            [self.entry_p, np.asarray(p, np.float32)])
        self.entry_score = np.concatenate(
            [self.entry_score, np.asarray(score, np.float32)])
        self.epoch += 1
        self.mseq = next_mseq()
        return added

    def ensure_row_capacity(self, n: int) -> None:
        """Grow every chunk's row capacity to at least ``n`` (geometric).

        Reallocates each chunk once, copying only the live rows; a no-op
        when the capacity already suffices. Bumps ``epoch`` (views alias the
        old arrays) but not ``mseq``: growth keeps membership as it is.
        """
        if n <= self.capacity:
            return
        new_cap = max(int(n), 2 * self.capacity)
        for c in range(self.n_chunks):
            blk = np.zeros((new_cap, self.chunks[c].shape[1]), np.int8)
            blk[: self.n_rows] = self.chunks[c][: self.n_rows]
            self.chunks[c] = blk
        self.capacity = new_cap
        self.epoch += 1

    def snapshot(self) -> "StoreSnapshot":
        """A rollback point: array references, not copies (O(chunks)).

        Valid because no mutation writes an existing entry column in place:
        entry mutations replace chunk and metadata arrays with extended
        copies, and row staging writes only rows ≥ ``n_rows``, which
        ``StoreSnapshot.restore`` zeroes back.
        """
        return StoreSnapshot(
            store=self, chunks=list(self.chunks), entry_item=self.entry_item,
            entry_value=self.entry_value, entry_p=self.entry_p,
            entry_score=self.entry_score, n_rows=self.n_rows,
            capacity=self.capacity, delta_start=self.delta_start,
            epoch=self.epoch)

    # -- (de)serialization --------------------------------------------------

    def state_dict(self, prefix: str = "store/") -> dict:
        """Flat ``{key: ndarray}`` dict capturing this store bit-exactly.

        The same keys as the JAX package's ``CorpusStore.state_dict``:
        chunks trimmed to the live rows, the layout version in ``meta``.
        """
        d = {
            prefix + "meta": np.array(
                [STORE_LAYOUT_VERSION, self.chunk_entries, self.n_rows,
                 -1 if self.delta_start is None else self.delta_start,
                 self.epoch, self.n_chunks], np.int64),
            prefix + "entry_item": self.entry_item,
            prefix + "entry_value": self.entry_value,
            prefix + "entry_p": self.entry_p,
            prefix + "entry_score": self.entry_score,
        }
        for c, blk in enumerate(self.chunks):
            d[f"{prefix}chunk_{c:05d}"] = blk[: self.n_rows]
        return d

    @classmethod
    def from_state_dict(cls, d: dict, prefix: str = "store/",
                        capacity: Optional[int] = None) -> "CorpusStore":
        """Rebuild a store from ``state_dict`` output, bit-exact.

        ``capacity`` re-establishes row slack (≥ the stored ``n_rows``;
        defaults to no slack). Raises ``ValueError`` on a layout version
        newer than this reader.
        """
        meta = np.asarray(d[prefix + "meta"], np.int64)
        version, chunk_entries, n_rows, delta_start, epoch, n_chunks = (
            int(x) for x in meta[:6])
        if version > STORE_LAYOUT_VERSION:
            raise ValueError(
                f"store layout version {version} is newer than this reader "
                f"({STORE_LAYOUT_VERSION})")
        cap = n_rows if capacity is None else max(int(capacity), n_rows)
        chunks = []
        for c in range(n_chunks):
            src = np.asarray(d[f"{prefix}chunk_{c:05d}"], np.int8)
            blk = np.zeros((cap, src.shape[1]), np.int8)
            blk[:n_rows] = src
            chunks.append(blk)
        return cls(
            chunks=chunks,
            entry_item=np.asarray(d[prefix + "entry_item"], np.int32),
            entry_value=np.asarray(d[prefix + "entry_value"], np.int32),
            entry_p=np.asarray(d[prefix + "entry_p"], np.float32),
            entry_score=np.asarray(d[prefix + "entry_score"], np.float32),
            chunk_entries=chunk_entries, n_rows=n_rows, capacity=cap,
            delta_start=None if delta_start < 0 else delta_start,
            epoch=epoch)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_dense(cls, V: np.ndarray, entry_item, entry_value, entry_p,
                   entry_score, chunk_entries: Optional[int] = None,
                   capacity: Optional[int] = None) -> "CorpusStore":
        """Wrap a dense ``(S, E)`` incidence (tests, reorders). The default
        keeps one chunk spanning all entries, so ``to_dense()`` stays a
        view."""
        S, E = V.shape
        cap = S if capacity is None else int(capacity)
        w = max(E, 1) if chunk_entries is None else align_chunk(chunk_entries)
        chunks = []
        for j0 in range(0, E, w):
            blk = np.zeros((cap, min(w, E - j0)), np.int8)
            blk[:S] = V[:, j0: j0 + blk.shape[1]]
            chunks.append(blk)
        return cls(chunks=chunks,
                   entry_item=np.asarray(entry_item, np.int32),
                   entry_value=np.asarray(entry_value, np.int32),
                   entry_p=np.asarray(entry_p, np.float32),
                   entry_score=np.asarray(entry_score, np.float32),
                   chunk_entries=w, n_rows=S, capacity=cap)

    @classmethod
    def from_claim_coords(cls, src: np.ndarray, col: np.ndarray,
                          n_rows: int, entry_item, entry_value, entry_p,
                          entry_score, chunk_entries: int,
                          capacity: Optional[int] = None) -> "CorpusStore":
        """Stream claim coordinates into chunks (the ``build_index`` path).

        ``src[k]`` / ``col[k]`` place claim k at incidence position
        (source, entry column). Claims are bucketed by chunk with one sort,
        then each chunk is allocated and scattered independently — the peak
        incidence allocation is ONE chunk, never the ``(S, E)`` whole.
        """
        w = align_chunk(chunk_entries)
        E = len(entry_item)
        cap = n_rows if capacity is None else int(capacity)
        order = np.argsort(col, kind="stable")
        src, col = src[order], col[order]
        n_chunks = -(-E // w) if E else 0
        bounds = np.searchsorted(col, np.arange(0, n_chunks + 1) * w)
        chunks = []
        for c in range(n_chunks):
            width = min(w, E - c * w)
            blk = np.zeros((cap, width), np.int8)
            lo, hi = bounds[c], bounds[c + 1]
            blk[src[lo:hi], col[lo:hi] - c * w] = 1
            chunks.append(blk)
        return cls(chunks=chunks,
                   entry_item=np.asarray(entry_item, np.int32),
                   entry_value=np.asarray(entry_value, np.int32),
                   entry_p=np.asarray(entry_p, np.float32),
                   entry_score=np.asarray(entry_score, np.float32),
                   chunk_entries=w, n_rows=n_rows, capacity=cap)


def _nonzero_2d(blk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of the nonzero cells of a C-contiguous int8 block.

    A sparse incidence is mostly zero words: the scan reads it eight bytes
    at a time and expands only the nonzero words, which is several times
    faster than ``np.nonzero`` over the bytes.
    """
    n, w = blk.shape
    if n == 0 or w == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if w % 8 or not blk.flags.c_contiguous:
        return np.nonzero(blk)
    words = np.flatnonzero(blk.view(np.uint64))
    sub = blk.reshape(-1, 8)[words]                       # (n_words, 8)
    wi, bi = np.nonzero(sub)
    flat = words[wi] * 8 + bi
    return flat // w, flat % w


# ---------------------------------------------------------------------------
# Bitpacked membership (the shard plane's resident form)
# ---------------------------------------------------------------------------

#: Byte → set-bit-count lookup table for ``packed_count_matmul``.
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.int64)


@dataclass(frozen=True)
class PackedBlock:
    """One bitpacked incidence block: int8 membership at 1 bit per entry.

    ``bits[r, :]`` is row ``r``'s membership packed MSB-first along the
    column axis (``np.packbits`` layout); ``width`` is the original column
    count, since the packed byte axis rounds up to a multiple of 8. Pad bits
    of the last byte are always zero, so AND/popcount over whole bytes never
    sees phantom members. Frozen: mutation paths unpack, edit, repack.
    """

    bits: np.ndarray           # (rows, ceil(width/8)) uint8
    width: int                 # original (unpacked) column count

    @property
    def nbytes(self) -> int:
        """Resident bytes — the packed payload (1 bit per entry)."""
        return int(self.bits.nbytes)

    @property
    def shape(self) -> tuple:
        """Logical (rows, width) of the unpacked block."""
        return (int(self.bits.shape[0]), int(self.width))


def pack_membership(block: np.ndarray) -> PackedBlock:
    """Pack a 0/1 membership block to 1 bit per entry (8× against int8).

    Any width: a width that is not a multiple of 8 pads the last byte with
    zero bits, which ``unpack_membership`` trims back.
    """
    block = np.ascontiguousarray(block)
    if block.ndim != 2:
        raise ValueError(f"pack_membership: need a 2-D block, got {block.shape}")
    return PackedBlock(bits=np.packbits(block != 0, axis=1),
                       width=int(block.shape[1]))


def unpack_membership(packed: PackedBlock, dtype=np.int8) -> np.ndarray:
    """Inverse of ``pack_membership`` — bit-exact for 0/1 input blocks."""
    out = np.unpackbits(packed.bits, axis=1, count=packed.width)
    return out.view(np.int8) if np.dtype(dtype) == np.int8 else out.astype(dtype)


def packed_count_matmul(a: PackedBlock, b: Optional[PackedBlock] = None,
                        dtype=np.float32, row_block: int = 256) -> np.ndarray:
    """``counts[i, j] = Σ_e a[i, e] · b[j, e]`` straight off the packed bits.

    Byte-wise AND + popcount: every partial sum is an exact small integer,
    so the result equals the int8 product in ``dtype`` (float32 holds
    integers below 2²⁴ exactly). ``b=None`` means ``a @ a.T``;
    ``row_block`` bounds the (rows_a · rows_b · bytes) AND temporary.
    """
    other = a if b is None else b
    if b is not None and a.width != b.width:
        raise ValueError(
            f"packed_count_matmul: width mismatch {a.width} vs {b.width}")
    n, m = a.bits.shape[0], other.bits.shape[0]
    out = np.zeros((n, m), dtype)
    step = max(int(row_block), 1)
    for i0 in range(0, n, step):
        anded = a.bits[i0: i0 + step, None, :] & other.bits[None, :, :]
        out[i0: i0 + step] = _POPCOUNT[anded].sum(axis=2).astype(dtype)
    return out


@dataclass
class StoreSnapshot:
    """Rollback point for one ``CorpusStore`` (refs captured by ``snapshot``)."""

    store: "CorpusStore"
    chunks: list
    entry_item: np.ndarray
    entry_value: np.ndarray
    entry_p: np.ndarray
    entry_score: np.ndarray
    n_rows: int
    capacity: int
    delta_start: Optional[int]
    epoch: int

    def restore(self) -> None:
        """Put the captured store back to its snapshot state, bit-exact.

        Restores the array references — ``capacity`` with them, since an
        ``ensure_row_capacity`` in between swapped in larger chunks and a
        grown capacity over the restored arrays would let ``append_rows``
        write past them — then zeroes the row slack of every chunk (staged
        rows were written in place). Draws a fresh ``mseq``: a restored
        state never aliases one seen before.
        """
        st = self.store
        st.chunks = list(self.chunks)
        st.capacity = self.capacity
        st.entry_item = self.entry_item
        st.entry_value = self.entry_value
        st.entry_p = self.entry_p
        st.entry_score = self.entry_score
        st.delta_start = self.delta_start
        st.epoch = self.epoch
        st.n_rows = self.n_rows
        st.mseq = next_mseq()
        st._views = {}
        st._views_key = None
        for c in st.chunks:
            c[self.n_rows:] = 0


__all__ = ["CorpusStore", "ChunkView", "PackedBlock", "StoreSnapshot",
           "DEFAULT_CHUNK_ENTRIES", "STORE_LAYOUT_VERSION", "align_chunk",
           "next_mseq", "pack_membership", "packed_count_matmul",
           "unpack_membership"]
