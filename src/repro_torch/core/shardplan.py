"""Tile-stack scatter. The row-range shard plane is not carried yet
(ROADMAP A10); this slice carries the scatter the tiled engine uses."""
from __future__ import annotations

import torch


def scatter_tile_stacks(grids, coords: torch.Tensor, stacks, n_blocks: int,
                        tile: int) -> None:
    """Scatter both orientations of every unordered tile into full grids.

    ``grids`` = [c_same, n_cnt, n_out, err], each (S_pad, S_pad) float32;
    ``stacks`` holds the five kernel channels (C→, C←, shared count, non-Ē
    count, error bound) as ``(len(coords), T, T)`` tensors on the grids'
    device. The blocked transpose of a grid is a view, so an indexed write
    on tile coordinates lands each (T, T) block in place. The (c, r) mirror
    of tile (r, c) is C_same←ᵀ for the score and the plain transpose for the
    symmetric-role channels; diagonal tiles write identical values twice.
    """
    rr, cc = coords[:, 0].long(), coords[:, 1].long()
    cf_t, cb_t, n_t, o_t, e_t = stacks
    for grid, fwd, bwd in (
        (grids[0], cf_t, cb_t.transpose(1, 2)),
        (grids[1], n_t, None),
        (grids[2], o_t, None),
        (grids[3], e_t, None),
    ):
        g4 = grid.view(n_blocks, tile, n_blocks, tile).permute(0, 2, 1, 3)
        g4[rr, cc] = fwd
        g4[cc, rr] = fwd.transpose(1, 2) if bwd is None else bwd


__all__ = ["scatter_tile_stacks"]
