"""Per-chunk block-OR reduction for tile∘chunk pruning.

The tiled engine prunes pair tiles per chunk with a block-OR reduction: for
chunk ``k``, ``g_k[b, e] = OR`` of the membership bits of entry ``e`` over
tile-row-block ``b``; ``chunk_keep[k] = (g_k @ g_k.T) > 0``. This slice
always takes the fresh reduction; the commit-maintained ``BlockOrCache`` is
not carried yet (ROADMAP A9).
"""
from __future__ import annotations

import numpy as np


def chunk_block_inc(store, c: int, tile: int, n_blocks: int) -> np.ndarray:
    """Fresh per-entry block-OR of chunk ``c`` — bool ``(n_blocks, width)``.

    Reduces the live rows of a dense store's chunk; a trailing partial
    block ORs the rows it has.
    """
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


__all__ = ["chunk_block_inc"]
