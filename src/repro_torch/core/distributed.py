"""The tile scan on one device.

The JAX package's ``sharded_tile_scores`` round-robins the surviving pair
tiles over a 1-D device mesh with ``shard_map``; each device scans its tiles
with ``lax.scan`` and skips ``(-1, -1)`` slots with ``lax.cond``. On one
card that becomes one kernel launch per chunk group over the whole surviving
coordinate list (or one shard owner's part of it, ``core/engine.py``), the
kernel itself returning at once on a ``(-1, -1)`` slot. Only the multi-card
mesh waits (ROADMAP A.3b): the 1-D tile mesh over several cards, the 2-D
``data``×``pod`` scan and ``distributed_pair_scores``.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import CopyConfig
from repro_torch.kernels.ops import tile_scores


def group_tile_scores(
    v: torch.Tensor,          # (S_pad, Gc, w) int8 group slab, on the device
    acc: torch.Tensor,        # (S_pad,) float32 accuracies (0.5 in padding rows)
    p_hat: torch.Tensor,      # (Gc,) float32 representative p̂ per chunk
    delta: torch.Tensor,      # (Gc,) float32 per-chunk score-error bound δ
    nout: torch.Tensor,       # (Gc,) float32 — 1.0 ⇔ chunk before the Ē boundary
    coords: torch.Tensor,     # (n_tiles, 2) int32 surviving (r ≤ c) tiles, (-1,-1) skip
    stacks,                   # five (n_tiles, T, T) float32 tile stacks
    cfg: CopyConfig,
    *,
    tile: int,
) -> None:
    """Add one chunk group's five channels into the per-tile stacks.

    The stacks stay on the device across groups; the caller scatters them
    into the (S, S) grids once, after the last group.
    """
    tile_scores(v, acc, p_hat, delta, nout, coords, stacks, tile=tile,
                s=cfg.s, n_false=cfg.n)


__all__ = ["group_tile_scores"]
