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

This slice carries what the build and the scan use; row and entry mutation
(``append_rows``, ``retract_rows``, delta chunks) is not carried yet.
"""
from __future__ import annotations

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

    # -- geometry -----------------------------------------------------------

    @property
    def n_entries(self) -> int:
        """E — total entry columns across chunks (padding included)."""
        return len(self.entry_item)

    @property
    def n_chunks(self) -> int:
        """Number of entry chunks."""
        return len(self.chunks)

    def chunk_start(self, c: int) -> int:
        """Global index of chunk ``c``'s first entry column."""
        return c * self.chunk_entries

    def chunk(self, c: int) -> ChunkView:
        """Chunk ``c`` as a handle: live rows + metadata views (zero copy)."""
        s0 = self.chunk_start(c)
        s1 = s0 + self.chunks[c].shape[1]
        return ChunkView(start=s0, V=self.chunks[c][: self.n_rows],
                         item=self.entry_item[s0:s1],
                         value=self.entry_value[s0:s1],
                         p=self.entry_p[s0:s1], score=self.entry_score[s0:s1])

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


__all__ = ["CorpusStore", "ChunkView", "DEFAULT_CHUNK_ENTRIES",
           "STORE_LAYOUT_VERSION", "align_chunk"]
