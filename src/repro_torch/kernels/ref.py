"""Plain PyTorch versions of the port's kernels, and the reference attention.

Each function has the semantics of its kernel (block-constant p̂, the same
channel order and the same float32 association; for attention the same
masking and float32 softmax), so the CPU tests hold it
against the JAX package and ``chip_smoke.py`` holds the kernel against it
on the card. On the card it is no yardstick of speed: it repeats the
kernel's arithmetic with one PyTorch call per step. ``attention_chunked``
is the reference attention at long sequences (8192 query rows and more),
in O(chunk·Sk) memory.
"""
from __future__ import annotations

import torch

#: Elements per temporary in the batched tile loop of ``tile_scores_torch``.
_TILE_BATCH_ELEMENTS = 1 << 24


def _pr_independent(p, a1, a2, n_false):
    """Eq. (3), a1·a2 first: bitwise invariant under a1 ↔ a2, so on a
    diagonal tile C← == C→ᵀ exactly (the kernels' association)."""
    return p * (a1 * a2) + (1.0 - p) * ((1.0 - a1) * (1.0 - a2)) / n_false


def _pair_score(p, a_src, pr_ind, s):
    """Eq. (6) with ``a_src`` the copied source's accuracy."""
    return torch.log(1.0 - s + s * (p * a_src + (1.0 - p) * (1.0 - a_src)) / pr_ind)


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
        pr_ind = _pr_independent(p_k, a1, a2, n_false)
        f_fwd = _pair_score(p_k, a2, pr_ind, s)
        f_bwd = _pair_score(p_k, a1, pr_ind, s)
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


def copyscore_torch(v, p_blk, acc, *, s: float, n_false: float, block_e: int,
                    v_cols=None, acc_cols=None, delta_blk=None):
    """Single-direction copyscore over one pair block — the plain
    counterpart of the JAX package's ``copyscore_ref`` /
    ``copyscore_pallas``, with the kernels' a1·a2-first association.

    ``v`` (S_i, E) and ``v_cols`` (S_j, E, default ``v``: the full square)
    incidence of any dtype with E a multiple of ``block_e``; rows copy from
    columns. Each entry block carries one p̂ (``p_blk``) and, with
    ``delta_blk``, one error bound δ. Returns (C_same→, n), or (C_same→, n,
    err) with ``delta_blk``, each (S_i, S_j) float32, summed over the blocks
    from zero in block order; counts are float32 products of the 0/1
    incidence, exact below 2²⁴.
    """
    vj = v if v_cols is None else v_cols
    accj = acc if acc_cols is None else acc_cols
    S_i, E = v.shape
    S_j = vj.shape[0]
    dev = v.device
    p_blk = torch.as_tensor(p_blk, dtype=torch.float32, device=dev)
    a1 = torch.as_tensor(acc, dtype=torch.float32, device=dev)[:, None]
    a2 = torch.as_tensor(accj, dtype=torch.float32, device=dev)[None, :]
    c = torch.zeros((S_i, S_j), dtype=torch.float32, device=dev)
    n = torch.zeros_like(c)
    err = None
    if delta_blk is not None:
        delta_blk = torch.as_tensor(delta_blk, dtype=torch.float32, device=dev)
        err = torch.zeros_like(c)
    for k in range(E // block_e):
        blk = slice(k * block_e, (k + 1) * block_e)
        count = v[:, blk].to(torch.float32) @ vj[:, blk].to(torch.float32).T
        f = _pair_score(p_blk[k], a2, _pr_independent(p_blk[k], a1, a2, n_false), s)
        c = c + f * count
        n = n + count
        if err is not None:
            err = err + delta_blk[k] * count
    return (c, n) if err is None else (c, n, err)


# ---------------------------------------------------------------------------
# exact pair rescore
# ---------------------------------------------------------------------------

#: Elements (pairs × items) per batch of ``pair_scores_torch``: bounds the
#: (P, D) temporaries the JAX version materializes in one shot.
PAIR_BATCH_ELEMENTS = 1 << 25


def pair_scores_torch(vals, p, acc, pairs_i, pairs_j, *, s: float,
                      n_false: float) -> torch.Tensor:
    """Exact C→[i, j] for an explicit list of pairs (one direction).

    ``vals`` (S, D) int32, ``p`` (S, D) float32 and ``acc`` (S,) float32 lie
    on the device the pair lists lie on. The pairs run in batches of at most
    ``PAIR_BATCH_ELEMENTS`` pair-items. Returns (n_pairs,) C→[i, j].
    """
    # imported here: ``core`` imports the kernels, not the other way
    from repro_torch.core.scoring import _ln_1ms, score_same

    D = vals.shape[1]
    out = torch.empty(len(pairs_i), dtype=torch.float32, device=vals.device)
    ln1ms = _ln_1ms(s, vals.device)
    zero = torch.zeros((), dtype=torch.float32, device=vals.device)
    step = max(1, PAIR_BATCH_ELEMENTS // max(D, 1))
    for b0 in range(0, len(pairs_i), step):
        pi = pairs_i[b0: b0 + step]
        pj = pairs_j[b0: b0 + step]
        vi, vj = vals[pi], vals[pj]                       # (B, D)
        shared = (vi >= 0) & (vj >= 0)
        same = shared & (vi == vj)
        sc = score_same(p[pi], acc[pi][:, None], acc[pj][:, None],
                        s, n_false)
        contrib = torch.where(same, sc, torch.where(shared, ln1ms, zero))
        out[b0: b0 + step] = contrib.sum(dim=-1)
    return out


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: The finite mask value of the JAX package's flash kernel.
NEG_INF = -1e30


def _visible(Sq: int, Sk: int, causal: bool, window, device):
    """(Sq, Sk) bool: key j visible from query i (absolute indices, as the
    JAX kernel's ``_block_mask``)."""
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= (qi - kj) < window
    return mask


def attention_ref(q, k, v, *, causal=True, sm_scale=None, window=None):
    """Reference attention. q (B,Hq,Sq,D); k,v (B,Hkv,Sk,D) with Hq % Hkv == 0.

    window (int): sliding-window size — key j visible from query i iff
    0 ≤ i − j < window (combined with causal). Logits and probabilities in
    float32, masked with -inf (a row with nothing visible is NaN), output in
    q's dtype: the JAX package's ``attention_ref``.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, group, Sq, D).to(torch.float32)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) * scale
    mask = _visible(Sq, Sk, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(torch.float32))
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def attention_chunked(q, k, v, *, causal=True, sm_scale=None, window=None,
                      chunk=2048, unroll=False):
    """Reference attention over chunks of ``chunk`` query rows, so that the
    float32 logits are (B, Hkv, group, chunk, Sk) at a time, O(chunk·Sk)
    where ``attention_ref``'s are O(Sq·Sk): the JAX package's
    ``attention_chunked``, with its memory design. k and v heads are never
    repeated to the q heads (one product over the GQA group), k and v stay
    in their dtype (each chunk's keys are taken to float32, so the products
    accumulate in float32 as JAX's ``preferred_element_type`` does), and a
    sliding-window layer reads only the min(window + chunk, Sk) keys a chunk
    can see, from where JAX's ``dynamic_slice`` starts them. Masked logits
    are the finite ``NEG_INF``, as JAX's; output in q's dtype. ``Sq`` must
    be a multiple of ``chunk``. ``unroll`` is accepted and changes nothing:
    JAX unrolls its ``lax.scan`` so that XLA's cost analysis counts every
    chunk, and this Python loop runs every chunk already."""
    del unroll
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    assert Sq % chunk == 0, (Sq, chunk)
    qg = q.reshape(B, Hkv, group, Sq, D)
    kwin = min(window + chunk, Sk) if window is not None else Sk
    if window is None:                    # every chunk reads every key
        k32, v32 = k.to(torch.float32), v.to(torch.float32)
    rows = torch.arange(chunk, device=q.device)[:, None]
    outs = []
    for c0 in range(0, Sq, chunk):
        if window is None:
            start, ks, vs = 0, k32, v32
        else:
            start = min(max(c0 + chunk - kwin, 0), Sk - kwin)
            ks = k[:, :, start:start + kwin].to(torch.float32)
            vs = v[:, :, start:start + kwin].to(torch.float32)
        qi = qg[:, :, :, c0:c0 + chunk].to(torch.float32)
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qi, ks) * scale
        q_pos = c0 + rows
        k_pos = start + torch.arange(kwin, device=q.device)[None, :]
        mask = torch.ones((chunk, kwin), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        probs = torch.softmax(logits.masked_fill_(~mask, NEG_INF), dim=-1)
        del logits
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", probs, vs).to(q.dtype))
        del probs
    return torch.cat(outs, dim=3).reshape(B, Hq, Sq, D)


def flash_attention_fwd_torch(q, k, v, *, causal=True, sm_scale=None,
                              window=None):
    """Plain version of the flash-attention forward kernel: (o, lse).

    q (B,Hq,Sq,D); k,v (B,Hkv,Sk,D), kv head = q head // (Hq // Hkv). Logits
    s = (q·k)·sm_scale in float32, masked with the finite ``NEG_INF``;
    m = max over the visible keys, p = exp(s − m) on visible keys and 0
    elsewhere, l = Σp, o = (p·v) / l in float32 (P is never rounded), cast
    to q's dtype, and lse = m + log l. A row with nothing visible gets o = 0
    and lse = NEG_INF + log 1, as the kernel gives it (l = 0 is replaced by
    1). Any Sq and Sk: nothing is tiled here.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, group, Sq, D).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) * scale
    mask = _visible(Sq, Sk, causal, window, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill_(~mask, 0.0)
    del s
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0.0, l, torch.ones_like(l))
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32)) / safe_l
    lse = (m + torch.log(safe_l))[..., 0]
    return o.reshape(B, Hq, Sq, D).to(q.dtype), lse.reshape(B, Hq, Sq)


def _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale, window):
    """Grouped (p, ds, q, do) of the backward, all float32 with q and do
    as (B, Hkv, group, Sq, D) and p, ds as (B, Hkv, group, Sq, Sk).

    p = exp(s − lse) on the visible keys, chosen by selection: a row with
    nothing visible has lse = NEG_INF + log 1, where exp(s − lse)
    overflows, and selection (never a product with the mask) keeps its p
    at 0. ds = p·(do·vᵀ − delta)·sm_scale.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, group, Sq, D).to(torch.float32)
    dog = do.reshape(B, Hkv, group, Sq, D).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) * scale
    mask = _visible(Sq, Sk, causal, window, q.device)
    lse_g = lse.reshape(B, Hkv, group, Sq, 1)
    p = torch.where(mask, torch.exp(s - lse_g), torch.zeros((), device=q.device))
    del s
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.to(torch.float32))
    ds = p * (dp - delta.reshape(B, Hkv, group, Sq, 1)) * scale
    return p, ds, qg, dog


def flash_attention_bwd_dq_torch(q, k, v, do, lse, delta, *, causal=True,
                                 sm_scale=None, window=None):
    """Plain version of the dq kernel: dq = ds·k in float32, cast to q's
    dtype. ``delta`` (B, Hq, Sq) float32 is rowsum(do·o)."""
    p, ds, _, _ = _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale, window)
    del p
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.to(torch.float32))
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_torch(q, k, v, do, lse, delta, *, causal=True,
                                  sm_scale=None, window=None):
    """Plain version of the dk/dv kernel: dk = dsᵀ·q and dv = pᵀ·do in
    float32, summed over each kv head's group of q heads, cast to k's and
    v's dtypes."""
    p, ds, qg, dog = _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale,
                                window)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    del p
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_torch(q, k, v, o, lse, do, *, causal=True,
                              sm_scale=None, window=None):
    """Plain version of the flash-attention backward: (dq, dk, dv).

    q, o, do (B, Hq, Sq, D); k, v (B, Hkv, Sk, D); lse (B, Hq, Sq) float32
    from the forward. delta = Σ(do·o) over D in float32; s recomputed,
    p = exp(s − lse) on visible keys only, dp = do·vᵀ,
    ds = p·(dp − delta)·scale, dq = ds·k, dk = dsᵀ·q and dv = pᵀ·do, dk
    and dv summed over each kv head's group. Any Sq and Sk; rows with
    nothing visible get zero gradients. Outputs in the inputs' dtypes.
    """
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    kw = dict(causal=causal, sm_scale=sm_scale, window=window)
    dq = flash_attention_bwd_dq_torch(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv_torch(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


__all__ = ["NEG_INF", "PAIR_BATCH_ELEMENTS", "attention_chunked",
           "attention_ref", "copyscore_fused_torch",
           "flash_attention_bwd_dkv_torch", "flash_attention_bwd_dq_torch",
           "flash_attention_bwd_torch", "flash_attention_fwd_torch",
           "pair_scores_torch", "tile_scores_torch"]
