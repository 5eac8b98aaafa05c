"""Plain PyTorch versions of the port's kernels.

Each function has the semantics of its kernel (block-constant p̂, the same
channel order and the same float32 association), so the CPU tests hold it
against the JAX package and ``chip_smoke.py`` holds the kernel against it
on the card. On the card it is no yardstick of speed: it repeats the
kernel's arithmetic with one PyTorch call per step.
"""
from __future__ import annotations

import torch

#: Elements per temporary in the batched tile loop of ``tile_scores_torch``.
_TILE_BATCH_ELEMENTS = 1 << 24


def _fused_channels(vi, vj, a1, a2, p_blk, d_blk, m_blk, s, n_false):
    """The five channels of a batch of pair tiles.

    vi (B, T_i, n_e, w) and vj (B, T_j, n_e, w) int8 incidence, a1 (B, T_i)
    row and a2 (B, T_j) column accuracies, p/δ/m (n_e,) per entry block.
    Returns (C→, C←, n, n_out, err), each (B, T_i, T_j) float32, summed
    over the blocks from zero in block order.
    """
    B, T_i, n_e, _ = vi.shape
    T_j = vj.shape[1]
    a1 = a1.to(torch.float32)[:, :, None]
    a2 = a2.to(torch.float32)[:, None, :]
    zero = torch.zeros((B, T_i, T_j), dtype=torch.float32, device=vi.device)
    cf, cb, n, n_out, err = (zero.clone() for _ in range(5))
    for k in range(n_e):
        count = torch.bmm(vi[:, :, k, :].to(torch.float32),
                          vj[:, :, k, :].to(torch.float32).transpose(1, 2))
        p_k, d_k, m_k = p_blk[k], d_blk[k], m_blk[k]
        # symmetric association (a1·a2 first): bitwise invariant under
        # a1↔a2, so on a diagonal tile C← == C→ᵀ exactly
        pr_ind = p_k * (a1 * a2) + (1.0 - p_k) * ((1.0 - a1) * (1.0 - a2)) / n_false
        f_fwd = torch.log(1.0 - s + s * (p_k * a2 + (1.0 - p_k) * (1.0 - a2)) / pr_ind)
        f_bwd = torch.log(1.0 - s + s * (p_k * a1 + (1.0 - p_k) * (1.0 - a1)) / pr_ind)
        cf = cf + f_fwd * count
        cb = cb + f_bwd * count
        n = n + count
        n_out = n_out + m_k * count
        err = err + d_k * count
    return cf, cb, n, n_out, err


def copyscore_fused_torch(v, p_blk, acc, *, s: float, n_false: float,
                          block_e: int, v_cols=None, acc_cols=None,
                          delta_blk=None, nout_blk=None):
    """Dual-direction copyscore over one pair tile — the plain counterpart
    of the JAX package's ``copyscore_fused_ref`` / ``copyscore_fused_pallas``.

    ``v`` (S_i, E) and ``v_cols`` (S_j, E) incidence with E a multiple of
    ``block_e``; each entry block carries one p̂ (``p_blk``), one error
    bound δ (``delta_blk``, default 0) and one non-Ē flag (``nout_blk``,
    default 1). Returns (C_same→, C_same←, n, n_out, err), each (S_i, S_j)
    float32. C_same←[i, j] scores column j copying from row i — its
    transpose is the mirrored tile's C_same→.
    """
    vj = v if v_cols is None else v_cols
    accj = acc if acc_cols is None else acc_cols
    S_i, E = v.shape
    S_j = vj.shape[0]
    n_e = E // block_e
    dev = v.device
    p_blk = torch.as_tensor(p_blk, dtype=torch.float32, device=dev)
    d_blk = (torch.zeros(n_e, dtype=torch.float32, device=dev) if delta_blk is None
             else torch.as_tensor(delta_blk, dtype=torch.float32, device=dev))
    m_blk = (torch.ones(n_e, dtype=torch.float32, device=dev) if nout_blk is None
             else torch.as_tensor(nout_blk, dtype=torch.float32, device=dev))
    outs = _fused_channels(v.reshape(1, S_i, n_e, block_e),
                           vj.reshape(1, S_j, n_e, block_e),
                           acc.reshape(1, S_i), accj.reshape(1, S_j),
                           p_blk, d_blk, m_blk, s, n_false)
    return tuple(o[0] for o in outs)


def tile_scores_torch(v, acc, p_hat, delta, nout, coords, stacks, *,
                      tile: int, s: float, n_false: float) -> None:
    """One chunk group over a tile list, added into the tile stacks.

    ``v`` (S_pad, Gc, w) int8 group slab, ``acc`` (S_pad,), ``p_hat`` /
    ``delta`` / ``nout`` (Gc,), ``coords`` (n_tiles, 2) int32 (row block,
    column block) with (-1, -1) marking a slot to leave untouched, and
    ``stacks`` the five (n_tiles, T, T) float32 channels, updated in place:
    each tile's group sum (from zero, in chunk order) is added once, as the
    kernel does.
    """
    T = tile
    _, Gc, w = v.shape
    live = torch.nonzero(coords[:, 0] >= 0).flatten()
    offs = torch.arange(T, device=v.device)
    step = max(1, _TILE_BATCH_ELEMENTS // (T * max(T, w * Gc)))
    for b0 in range(0, len(live), step):
        t = live[b0: b0 + step]
        rows = (coords[t, 0].long() * T)[:, None] + offs       # (B, T)
        cols = (coords[t, 1].long() * T)[:, None] + offs
        outs = _fused_channels(v[rows], v[cols], acc[rows], acc[cols],
                               p_hat, delta, nout, s, n_false)
        for st, o in zip(stacks, outs):
            st[t] = st[t] + o


__all__ = ["copyscore_fused_torch", "tile_scores_torch"]
