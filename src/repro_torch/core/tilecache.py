"""Per-chunk block-OR reduction for tile∘chunk pruning, and its
commit-maintained cache.

The tiled engine prunes pair tiles per chunk with a block-OR reduction: for
chunk ``k``, ``g_k[b, e] = OR`` of the membership bits of entry ``e`` over
tile-row-block ``b``; ``chunk_keep[k] = (g_k @ g_k.T) > 0``. A fresh pass
regathers all K reductions — O(S·E) host work — even when the corpus
changed by one commit of a few rows.

``BlockOrCache`` keeps the per-entry block incidence **over the committed
base store** (not the per-detect gathered store, whose column order changes
every pass) and updates it from the ``MutationDelta`` a commit/retraction
emits:

  * **commit** — membership is monotone under a commit (bits are only ever
    set, and only in the appended rows), so OR-ing the new rows' bits into
    the trailing block rows of the ``touched`` entries is exact. Brand-new
    entry columns get a fresh column reduction (their provider sets span
    old rows too).
  * **retraction** — rows ≥ ``row_start`` compact upward, so every block
    row ≥ ``row_start // tile`` is recomputed from the post-retraction
    store (one slab per chunk, not the whole corpus) and GC'd columns are
    zeroed everywhere.

Validity is anchored on ``store.mseq``, a globally monotonic
mutation-sequence number that snapshot restores refresh rather than
rewind, so a (store, mseq) pair never names two bit states. Any mismatch,
or a compaction (``full=True`` delta), marks the cache stale; the next
detect pass rebuilds it as a side product of its fresh block-OR loop.

At detect time the engine derives each *gathered* chunk's mask by permuting
cached base columns through ``EngineChunks.order`` — gathered column ``j``
is base column ``order[j]`` over the same rows (−1 markers are inert zero
columns) — bit-equal to a fresh reduction of the gathered chunk. This is
the JAX package's cache, over a plain ``CorpusStore`` (read directly) or
a ``ShardedCorpusStore`` (read through its facade: ``assemble_rows``,
``block_or``, ``chunk_width``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.store import CorpusStore


def _rows_slab(store, c: int, r0: int, r1: int) -> np.ndarray:
    """Dense int8 ``(r1 − r0, width_c)`` row slab of chunk ``c``; rows
    beyond the chunk's capacity read as zero, so tile-aligned requests are
    always safe."""
    if not isinstance(store, CorpusStore):
        return store.assemble_rows(c, r0, r1)
    blk = store.chunks[c]
    out = np.zeros((r1 - r0, blk.shape[1]), np.int8)
    hi = min(r1, blk.shape[0])
    if hi > r0:
        out[: hi - r0] = blk[r0:hi]
    return out


def chunk_block_inc(store, c: int, tile: int, n_blocks: int) -> np.ndarray:
    """Fresh per-entry block-OR of chunk ``c`` — bool ``(n_blocks, width)``.

    The one full-chunk reduction (the engine's cache-miss path and the
    cache's builds route through it). Reduces the live rows; a trailing
    partial block ORs the rows it has. A sharded store reduces shard by
    shard (``block_or``): no host assembles the full chunk.
    """
    if not isinstance(store, CorpusStore):
        return store.block_or(c, tile, n_blocks)
    blk = store.chunks[c]
    w = blk.shape[1]
    out = np.zeros((n_blocks, w), bool)
    nr = min(store.n_rows, n_blocks * tile)
    full = nr // tile
    if full:
        # incidence is 0/1 int8, so a max over the rows is the OR
        out[:full] = blk[: full * tile].reshape(full, tile, w).max(axis=1) != 0
    if full * tile < nr and full < n_blocks:
        out[full] = (blk[full * tile: nr] != 0).any(axis=0)
    return out


def cols_block_inc(store, c: int, cols: np.ndarray, tile: int,
                   n_blocks: int) -> np.ndarray:
    """Block-OR restricted to local columns ``cols`` of chunk ``c``.

    O(rows · |cols|) — the commit path fills brand-new entry columns with
    it without a full-chunk regather (``chunk_block_inc``).
    """
    cols = np.asarray(cols, np.int64)
    if isinstance(store, CorpusStore):
        blk = store.chunks[c]
        sub = np.zeros((n_blocks * tile, len(cols)), np.int8)
        nr = min(store.n_rows, blk.shape[0], n_blocks * tile)
        if nr > 0:
            sub[:nr] = blk[:nr, cols]
    else:
        sub = store.assemble_rows(c, 0, n_blocks * tile)[:, cols]
    return (sub != 0).reshape(n_blocks, tile, len(cols)).any(axis=1)


class BlockOrCache:
    """Per-entry tile-block incidence over one base store, delta-updated.

    ``block_inc[b, e]`` is True iff any row of tile-block ``b`` provides
    entry ``e``. ``blocks_updated`` accumulates the (entry, block) cells
    written by incremental applies — the O(touched) work, against the
    O(K·E) of a regather.
    """

    def __init__(self, store, tile: int, mseq: int, block_inc: np.ndarray):
        """Wrap an already-computed incidence (the engine's adoption path)."""
        self.store = store
        self.tile = int(tile)
        self.mseq = int(mseq)
        self.block_inc = block_inc
        self.blocks_updated = 0
        self.stale = False

    @classmethod
    def build(cls, store, tile: int) -> "BlockOrCache":
        """Full build straight from a store (tests / standalone use)."""
        tile = int(tile)
        nb = -(-max(store.n_rows, 0) // tile)
        inc = np.zeros((nb, store.n_entries), bool)
        w = store.chunk_entries
        for c in range(store.n_chunks):
            g = chunk_block_inc(store, c, tile, nb)
            inc[:, c * w: c * w + g.shape[1]] = g
        return cls(store, tile, store.mseq, inc)

    def matches(self, store, tile: int) -> bool:
        """True when this cache is valid for ``store`` at ``tile``."""
        return (not self.stale and store is self.store
                and int(tile) == self.tile
                and self.mseq == getattr(store, "mseq", -1))

    def chunk_mask(self, order_slice: np.ndarray) -> np.ndarray:
        """Mask of a GATHERED chunk: column ``j`` = base column
        ``order_slice[j]`` (−1 markers are inert, all-False columns)."""
        order_slice = np.asarray(order_slice, np.int64)
        g = np.zeros((self.block_inc.shape[0], len(order_slice)), bool)
        live = order_slice >= 0
        if live.any():
            g[:, live] = self.block_inc[:, order_slice[live]]
        return g

    def apply(self, delta) -> Optional[tuple]:
        """Update from one ``MutationDelta``; returns an undo token.

        Commits return a token for ``undo`` (a transient
        commit→detect→rollback); retractions return None. Any mismatch —
        wrong ``from_mseq``, compaction (``full``), missing delta — marks
        the cache stale instead of guessing; the next detect rebuilds it.
        """
        if (delta is None or self.stale or delta.full
                or delta.from_mseq != self.mseq):
            self.stale = True
            return None
        if delta.kind == "commit":
            return self._apply_commit(delta)
        self._apply_retract(delta)
        return None

    def _apply_commit(self, delta) -> tuple:
        """Monotone OR update: new rows of touched + fresh new columns."""
        T = self.tile
        store = self.store
        nb_old, E_old = self.block_inc.shape
        rb0 = delta.from_rows // T
        nb_new = -(-delta.to_rows // T)
        undo = (rb0, (nb_old, E_old), self.block_inc[rb0:].copy())
        E_new = store.n_entries
        grown = np.zeros((nb_new, E_new), bool)
        grown[:nb_old, :E_old] = self.block_inc
        self.block_inc = grown
        cells = 0
        touched = np.asarray(delta.touched, np.int64)
        w = store.chunk_entries
        if len(touched) and nb_new > rb0:
            slab_rows = (nb_new - rb0) * T
            for cid in np.unique(touched // w):
                cols = touched[touched // w == cid]
                slab = _rows_slab(store, int(cid), rb0 * T, rb0 * T + slab_rows)
                sub = slab[:, cols - cid * w] != 0
                self.block_inc[rb0:, cols] |= sub.reshape(
                    nb_new - rb0, T, len(cols)).any(axis=1)
            cells += len(touched) * (nb_new - rb0)
        ns = delta.new_entry_start
        if 0 <= ns < E_new:
            for cid in range(ns // w, store.n_chunks):
                s0 = cid * w
                wc = store.chunk_width(cid)
                lo = max(ns, s0)
                if lo >= s0 + wc:
                    continue
                local = np.arange(lo - s0, wc)
                self.block_inc[:, lo: s0 + wc] = cols_block_inc(
                    store, cid, local, T, nb_new)
                cells += len(local) * nb_new
        self.blocks_updated += cells
        self.mseq = delta.to_mseq
        return undo

    def _recompute_tail(self, to_rows: int, row_start: int) -> None:
        """Resize to ``to_rows`` and recompute block rows ≥ ``row_start``.

        Columns truncate/grow to the store's current entry count, surviving
        leading block rows copy over, and every block row from
        ``row_start // tile`` on is recomputed from the store's current
        rows (one slab per chunk).
        """
        T = self.tile
        store = self.store
        nb_new = -(-to_rows // T) if to_rows > 0 else 0
        E = store.n_entries
        new_inc = np.zeros((nb_new, E), bool)
        keep = min(self.block_inc.shape[0], nb_new)
        new_inc[:keep] = self.block_inc[:keep, :E]
        self.block_inc = new_inc
        rb0 = row_start // T
        if nb_new > rb0:
            w = store.chunk_entries
            for cid in range(store.n_chunks):
                slab = _rows_slab(store, cid, rb0 * T, nb_new * T)
                wc = slab.shape[1]
                self.block_inc[rb0:, cid * w: cid * w + wc] = (
                    slab != 0).reshape(nb_new - rb0, T, wc).any(axis=1)
            self.blocks_updated += (nb_new - rb0) * E

    def _apply_retract(self, delta) -> None:
        """Zero GC'd columns; recompute every block row ≥ the first
        retracted row (compaction shifted everything after it up)."""
        self._recompute_tail(delta.to_rows, delta.row_start)
        gc = delta.gc_entries
        if gc is not None and len(gc):
            # deactivated columns zero everywhere, including rows < row_start
            # the tail recompute never touched
            self.block_inc[:, np.asarray(gc, np.int64)] = False
        self.mseq = delta.to_mseq

    def rebase(self, delta) -> None:
        """Re-anchor a cache adopted DURING a transient commit onto the
        rolled-back base store.

        A cache the detect pass adopts mid-transient (``mseq ==
        delta.to_mseq``) would die with the rollback. After
        ``rollback_commit`` restored the store, dropping the appended
        columns, shrinking back to the pre-commit block rows and recomputing
        the boundary block row yields the exact base-state incidence.
        Anything that doesn't match goes stale instead.
        """
        if (delta is None or self.stale or delta.kind != "commit"
                or delta.to_mseq != self.mseq):
            self.stale = True
            return
        self._recompute_tail(delta.from_rows, delta.row_start)
        self.mseq = getattr(self.store, "mseq", -1)

    def undo(self, token: Optional[tuple]) -> None:
        """Reverse a committed ``apply`` after the store was rolled back.

        Call right after ``rollback_commit`` restored the store: the cache
        re-anchors on the store's post-rollback ``mseq``, and the saved
        trailing block rows put the incidence back bit-exact. ``None``
        tokens are no-ops.
        """
        if token is None:
            return
        rb0, (nb_old, E_old), tail = token
        blk = np.zeros((nb_old, E_old), bool)
        blk[:rb0] = self.block_inc[:rb0, :E_old]
        blk[rb0:] = tail
        self.block_inc = blk
        self.mseq = getattr(self.store, "mseq", -1)
        self.stale = False


__all__ = ["BlockOrCache", "chunk_block_inc", "cols_block_inc"]
