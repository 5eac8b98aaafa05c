"""Dispatching wrappers for the port's kernels.

``tile_scores``          — one chunk group over a tile list, added into the
                           five tile stacks: the production call of the
                           tiled engine. A CPU tensor takes the plain version
                           (``ref.tile_scores_torch``); a CUDA tensor launches
                           the hand-written Hopper kernel
                           (``csrc/copyscore_fused.cu``) or raises. There is
                           no fallback from the kernel to the plain version.
``copyscore_tile_fused`` — one square pair tile, both directions, from row
                           and column incidence: the counterpart of the JAX
                           package's ``ops.copyscore_tile_fused``, on the same
                           dispatch.

``copyscore``            — C→ and shared counts over the full S×S square;
``copyscore_tile``       — one rectangular pair tile, rows copy from
                           columns, with the error channel when given δ;
``copyscore_store``      — the full square streamed from a chunked
                           ``CorpusStore``, one launch per live chunk,
                           accumulated on the device. All three reach
                           ``csrc/copyscore.cu`` on a CUDA tensor (B3, and
                           B2 with the error channel, on the int8 tensor
                           cores), and ``ref.copyscore_torch`` on a CPU
                           tensor.
``pad_for_copyscore``    — host-side padding of buckets and rows to kernel
                           block multiples.
``pair_scores``          — exact C→[i, j] and C→[j, i] over all items for a
                           list of source pairs: the exact rescore of every
                           engine mode. A CPU tensor takes the plain version
                           (``ref.pair_scores_torch``, once a direction); a
                           CUDA tensor launches the hand-written kernel
                           (``csrc/pair_rescore.cu``) or raises.

``flash_attention_fwd``  — attention forward (o, lse) with causal masking,
                           a sliding window and GQA: a CPU tensor takes the
                           plain version (``ref.flash_attention_fwd_torch``);
                           a CUDA tensor launches the hand-written Hopper
                           kernel (``csrc/flash_attention_fwd.cu``) or raises.
``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv`` — the two
                           backward kernels (dq; dk and dv), from the
                           forward's lse and delta = rowsum(do·o), on the
                           same dispatch (``csrc/flash_attention_bwd.cu``).
``flash_attention_bwd``  — the backward (dq, dk, dv) from (q, k, v, o, lse,
                           do): delta in plain torch, then both kernels.
``FlashAttention``       — the ``torch.autograd.Function`` of the two: its
                           forward is ``flash_attention_fwd``, its backward
                           ``flash_attention_bwd``.
``flash_counts``         — the operations and bytes of one call of B4, B5 or
                           B6: 2, 3 and 4 products of 2·D a visible (query,
                           key) pair (``visible_pairs``), each operand read
                           once and each output written once. The bounds of
                           ``chip_smoke.py`` and the ``meta`` branches take
                           their counts from it.
``flash_attention``      — the model's attention: ``impl="kernel"`` goes
                           through ``FlashAttention``, ``impl="reference"``
                           is the plain ``ref.attention_ref``, chunked
                           (``ref.attention_chunked``) from 8192 query rows
                           on, and ``"chunked"`` / ``"chunked_unroll"`` the
                           chunked form at every length (all differentiated
                           by autograd).

On a ``meta`` tensor the three flash wrappers launch nothing: they return
outputs of the kernel's shapes and dtypes and report ``flash_counts`` to
``utils.costs`` (the counters of ``launch.roofline.analyze_step``). That
branch is no fallback: ``meta`` computes nothing. The copy-score wrappers
have no such branch: no shapes-only run reaches them.

``tile_scores.launches``, ``copyscore.launches``,
``copyscore_tile.launches``, ``copyscore_store.launches``,
``pair_scores.launches``,
``flash_attention_fwd.launches``, ``flash_attention_bwd_dq.launches`` and
``flash_attention_bwd_dkv.launches`` count the kernel launches of this
process (plain integers; a caller resets one to 0 to count a run).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.utils.costs import record_kernel

_CHANNELS = 5


def _copyscore_lib() -> ctypes.CDLL:
    lib = _build.load("copyscore_fused")
    fn = lib.copyscore_fused_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.copyscore_error_string.restype = ctypes.c_char_p
        lib.copyscore_error_string.argtypes = [ctypes.c_int]
    return lib


def _check_group(v, acc, p_hat, delta, nout, coords, stacks, tile):
    """Raise on any operand the kernel does not take."""
    if v.dtype != torch.int8 or v.dim() != 3:
        raise ValueError(f"v must be (S_pad, Gc, w) int8, got {tuple(v.shape)} "
                         f"{v.dtype}")
    S_pad, Gc, w = v.shape
    if w % 8 or tile <= 0 or S_pad % tile:
        raise ValueError(f"need w % 8 == 0 and S_pad % tile == 0 "
                         f"(w={w}, S_pad={S_pad}, tile={tile})")
    if coords.dtype != torch.int32 or coords.dim() != 2 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (n_tiles, 2) int32, got "
                         f"{tuple(coords.shape)} {coords.dtype}")
    n_tiles = coords.shape[0]
    named = {"acc": (acc, (S_pad,)), "p_hat": (p_hat, (Gc,)),
             "delta": (delta, (Gc,)), "nout": (nout, (Gc,))}
    if len(stacks) != _CHANNELS:
        raise ValueError(f"need {_CHANNELS} stacks, got {len(stacks)}")
    for c, st in enumerate(stacks):
        named[f"stacks[{c}]"] = (st, (n_tiles, tile, tile))
    for name, (t, shape) in named.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in [("v", v), ("coords", coords)] + [
            (k, t) for k, (t, _) in named.items()]:
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tile_scores(v: torch.Tensor, acc: torch.Tensor, p_hat: torch.Tensor,
                delta: torch.Tensor, nout: torch.Tensor, coords: torch.Tensor,
                stacks, *, tile: int, s: float, n_false: float) -> None:
    """One chunk group over a tile list, added into ``stacks`` in place.

    ``v`` (S_pad, Gc, w) int8 group slab; ``acc`` (S_pad,) float32
    accuracies (0.5 in padding rows); ``p_hat`` / ``delta`` / ``nout``
    (Gc,) float32 per-chunk p̂, error bound δ and non-Ē flag; ``coords``
    (n_tiles, 2) int32 (row block, column block) with r ≤ c, (-1, -1)
    marking a slot to leave untouched; ``stacks`` the five (n_tiles, T, T)
    float32 channels (C→, C←, count, non-Ē count, error bound). Every tile
    slot's group sum is added once.
    """
    _check_group(v, acc, p_hat, delta, nout, coords, stacks, tile)
    if v.device.type == "cpu":
        kref.tile_scores_torch(v, acc, p_hat, delta, nout, coords, stacks,
                               tile=tile, s=s, n_false=n_false)
        return
    if v.device.type != "cuda":
        raise ValueError(f"tile_scores runs on cpu or cuda, not {v.device}")
    if v.data_ptr() % 8:
        raise ValueError("v must start on an 8-byte boundary")
    n_tiles = coords.shape[0]
    if n_tiles == 0:
        return
    lib = _copyscore_lib()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        code = lib.copyscore_fused_launch(
            v.data_ptr(), acc.data_ptr(), p_hat.data_ptr(), delta.data_ptr(),
            nout.data_ptr(), coords.data_ptr(),
            *(st.data_ptr() for st in stacks),
            n_tiles, tile, v.shape[1], v.shape[2],
            float(s), float(1.0 - s), float(n_false), stream)
    if code != 0:
        raise RuntimeError(f"copyscore_fused launch failed: "
                           f"{lib.copyscore_error_string(code).decode()}")
    tile_scores.launches += 1


tile_scores.launches = 0


def copyscore_tile_fused(v_rows, v_cols, p_blk, acc_rows, acc_cols, *,
                         s: float, n_false: float, block_e: int,
                         delta_blk=None, nout_blk=None):
    """One square pair tile, both directions: (C→, C←, n, n_out, err).

    ``v_rows`` / ``v_cols`` (T, E) int8 incidence with E a multiple of
    ``block_e``; one p̂ / δ / non-Ē flag per entry block. A CPU tensor takes
    ``ref.copyscore_fused_torch``; a CUDA tensor goes through ``tile_scores``
    (one kernel launch over the tile pair, rows then columns).
    """
    if v_rows.device.type == "cpu":
        return kref.copyscore_fused_torch(
            v_rows, p_blk, acc_rows, s=s, n_false=n_false, block_e=block_e,
            v_cols=v_cols, acc_cols=acc_cols, delta_blk=delta_blk,
            nout_blk=nout_blk)
    T, E = v_rows.shape
    if tuple(v_cols.shape) != (T, E) or E % block_e:
        raise ValueError(f"need square tiles with E % block_e == 0, got "
                         f"{tuple(v_rows.shape)} and {tuple(v_cols.shape)}")
    dev = v_rows.device
    n_e = E // block_e

    def blocks(x, default):
        x = torch.full((n_e,), default) if x is None else torch.as_tensor(x)
        return x.to(device=dev, dtype=torch.float32).contiguous()

    v = torch.cat([v_rows, v_cols]).reshape(2 * T, n_e, block_e).contiguous()
    acc = torch.cat([acc_rows, acc_cols]).to(torch.float32).contiguous()
    coords = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    stacks = [torch.zeros((1, T, T), dtype=torch.float32, device=dev)
              for _ in range(_CHANNELS)]
    tile_scores(v, acc, blocks(p_blk, 0.5), blocks(delta_blk, 0.0),
                blocks(nout_blk, 1.0), coords, stacks, tile=T, s=s,
                n_false=n_false)
    return tuple(st[0] for st in stacks)


# ---------------------------------------------------------------------------
# exact pair rescore
# ---------------------------------------------------------------------------

def _pair_lib() -> ctypes.CDLL:
    lib = _build.load("pair_rescore")
    fn = lib.pair_rescore_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                       + [ctypes.c_void_p])
        lib.pair_rescore_error_string.restype = ctypes.c_char_p
        lib.pair_rescore_error_string.argtypes = [ctypes.c_int]
    return lib


def _check_pairs(vals, p, acc, pi, pj) -> None:
    """Raise on any operand the kernel (on a CUDA tensor) or the plain
    version (on a CPU tensor) does not take."""
    if vals.dtype != torch.int32 or vals.dim() != 2:
        raise ValueError(f"vals must be (S, D) int32, got {tuple(vals.shape)} "
                         f"{vals.dtype}")
    S = vals.shape[0]
    if p.dtype != torch.float32 or p.shape != vals.shape:
        raise ValueError(f"p must be {tuple(vals.shape)} float32, got "
                         f"{tuple(p.shape)} {p.dtype}")
    if acc.dtype != torch.float32 or tuple(acc.shape) != (S,):
        raise ValueError(f"acc must be ({S},) float32, got {tuple(acc.shape)} "
                         f"{acc.dtype}")
    for name, t in (("pairs_i", pi), ("pairs_j", pj)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name} must be (P,) int64, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if len(pi) != len(pj):
        raise ValueError(f"pairs_i has {len(pi)} pairs, pairs_j {len(pj)}")
    for name, t in (("p", p), ("acc", acc), ("pairs_i", pi), ("pairs_j", pj)):
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on {vals.device}")


def pair_scores(vals: torch.Tensor, p: torch.Tensor, acc: torch.Tensor,
                pairs_i: torch.Tensor, pairs_j: torch.Tensor, *, s: float,
                n_false: float) -> tuple:
    """Exact (C→[i, j], C→[j, i]) over all items for each listed pair.

    ``vals`` (S, D) int32 values (-1 where a source provides none), ``p``
    (S, D) float32 truth probability of each provided value, ``acc`` (S,)
    float32 accuracies; ``pairs_i`` / ``pairs_j`` (P,) int64 row indices in
    [0, S). Returns two (P,) float32 tensors. A CPU tensor takes the plain
    version, once a direction; a CUDA tensor launches the kernel, which
    scores both directions from one read of each pair's two value rows (a
    pair outside [0, S) reads nothing and scores NaN there).
    """
    _check_pairs(vals, p, acc, pairs_i, pairs_j)
    dev = vals.device
    if dev.type == "cpu":
        return (kref.pair_scores_torch(vals, p, acc, pairs_i, pairs_j, s=s,
                                       n_false=n_false),
                kref.pair_scores_torch(vals, p, acc, pairs_j, pairs_i, s=s,
                                       n_false=n_false))
    if dev.type != "cuda":
        raise ValueError(f"pair_scores runs on cpu or cuda, not {dev}")
    S, D = vals.shape
    if S > _MAX_ROWS or D > _MAX_ROWS:
        raise ValueError(f"vals {tuple(vals.shape)}: the kernel takes fewer "
                         f"than 2**31 rows and items")
    n_pairs = len(pairs_i)
    c_ij = torch.empty(n_pairs, dtype=torch.float32, device=dev)
    c_ji = torch.empty(n_pairs, dtype=torch.float32, device=dev)
    if n_pairs == 0:
        return c_ij, c_ji
    # the kernel reads rows: a strided operand (the pair lists of
    # torch.nonzero(..., as_tuple=True), a column-sampled dataset's values)
    # is copied once into rows
    vals, p, acc = vals.contiguous(), p.contiguous(), acc.contiguous()
    pi, pj = pairs_i.contiguous(), pairs_j.contiguous()
    lib = _pair_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pair_rescore_launch(
            vals.data_ptr(), p.data_ptr(), acc.data_ptr(),
            pi.data_ptr(), pj.data_ptr(), c_ij.data_ptr(), c_ji.data_ptr(),
            n_pairs, S, D, float(s), float(1.0 - s), float(n_false), stream)
    if code != 0:
        raise RuntimeError(f"pair_rescore launch failed: "
                           f"{lib.pair_rescore_error_string(code).decode()}")
    pair_scores.launches += 1
    return c_ij, c_ji


pair_scores.launches = 0


# ---------------------------------------------------------------------------
# single-direction copyscore: the full square, one pair tile, a chunked store
# ---------------------------------------------------------------------------

#: the C interface takes row counts as int
_MAX_ROWS = 2 ** 31 - 1

#: B2's tile edge (``copyscore_tc_kernel<true, true>``'s 128×128 pair tiles)
_ERR_TILE = 128


def _single_lib() -> ctypes.CDLL:
    lib = _build.load("copyscore")
    fn = lib.copyscore_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.copyscore_single_error_string.restype = ctypes.c_char_p
        lib.copyscore_single_error_string.argtypes = [ctypes.c_int]
    return lib


def _as_blocks(x, n, dev, name):
    """A per-row or per-block float32 vector of length ``n`` on ``dev``."""
    t = torch.as_tensor(x).to(device=dev, dtype=torch.float32).contiguous()
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
    return t


def _single_operands(v_rows, v_cols, acc_rows, acc_cols, p_blk, delta_blk,
                     block_e):
    """Check the incidence of one pair block; return its small operands as
    float32 vectors on its device. Raises on anything the kernel (on a CUDA
    tensor) or the plain version (on a CPU tensor) does not take."""
    if v_rows.dim() != 2 or v_cols.dim() != 2 or v_rows.shape[1] != v_cols.shape[1]:
        raise ValueError(f"need (S_i, E) and (S_j, E) incidence, got "
                         f"{tuple(v_rows.shape)} and {tuple(v_cols.shape)}")
    E = v_rows.shape[1]
    if block_e <= 0 or E % block_e:
        raise ValueError(f"E={E} must be a multiple of block_e={block_e}")
    dev = v_rows.device
    if v_cols.device != dev:
        raise ValueError(f"v_cols is on {v_cols.device}, v_rows on {dev}")
    n_e = E // block_e
    small = (_as_blocks(acc_rows, v_rows.shape[0], dev, "acc_rows"),
             _as_blocks(acc_cols, v_cols.shape[0], dev, "acc_cols"),
             _as_blocks(p_blk, n_e, dev, "p_blk"),
             None if delta_blk is None
             else _as_blocks(delta_blk, n_e, dev, "delta_blk"))
    if dev.type == "cpu":
        return small
    if dev.type != "cuda":
        raise ValueError(f"copyscore runs on cpu or cuda, not {dev}")
    for name, t in (("v_rows", v_rows), ("v_cols", v_cols)):
        if t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int8 on the card, got "
                             f"{t.dtype}")
        if t.shape[0] > _MAX_ROWS or t.data_ptr() % 4:
            raise ValueError(f"{name}: at most {_MAX_ROWS} rows, starting on a "
                             f"4-byte boundary")
    if block_e % 4:
        raise ValueError(f"the kernel reads 4 entries a word: block_e={block_e} "
                         f"must be a multiple of 4 (pad_for_copyscore pads "
                         f"buckets to such a width)")
    return small


def _err_splits(n_blocks: int, s_i: int, s_j: int, sms: int) -> int:
    """The number m of contiguous ranges into which B2 splits its
    ``n_blocks`` entry blocks, one grid row of 128×128 pair tiles each: as
    few as bring the blocks to ``sms`` (one block an SM), at most one per
    entry block. The kernel takes range k as [k·n_blocks // m, (k + 1)·
    n_blocks // m), so with m ≤ n_blocks none is empty."""
    tiles = -(-s_i // _ERR_TILE) * -(-s_j // _ERR_TILE)
    return max(1, min(n_blocks, -(-sms // tiles)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_single(v_rows, v_cols, small, outs, *, block_e: int,
                   accumulate: bool, s: float, n_false: float) -> None:
    """Launch ``csrc/copyscore.cu`` over one pair block on the current
    stream of its device: ``outs`` = (C→, n) selects B3, (C→, n, err) B2,
    whose entry blocks are split by ``_err_splits`` across a workspace
    allocated here; written, or added to with ``accumulate``. Raises on a
    CUDA error."""
    acc_rows, acc_cols, p_blk, delta_blk = small
    lib = _single_lib()
    dev = v_rows.device
    S_i, S_j, n_e = v_rows.shape[0], v_cols.shape[0], v_rows.shape[1] // block_e
    n_splits, work = 1, None
    if len(outs) == 3:
        n_splits = _err_splits(n_e, S_i, S_j, _sm_count(dev.index))
        if n_splits > 1:
            work = torch.empty((n_splits, 3, S_i, S_j), dtype=torch.float32,
                               device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.copyscore_launch(
            v_rows.data_ptr(), v_cols.data_ptr(), acc_rows.data_ptr(),
            acc_cols.data_ptr(), p_blk.data_ptr(),
            None if delta_blk is None else delta_blk.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if len(outs) == 3 else None,
            None if work is None else work.data_ptr(),
            S_i, S_j, n_e, block_e, n_splits, int(accumulate), float(s),
            float(1.0 - s), float(n_false), stream)
    if code != 0:
        raise RuntimeError(f"copyscore launch failed: "
                           f"{lib.copyscore_single_error_string(code).decode()}")


def _pair_block(v_rows, v_cols, p_blk, acc_rows, acc_cols, *, s, n_false,
                block_e, delta_blk):
    """One pair block, rows copy from columns: the plain version on a CPU
    tensor, else one kernel launch into fresh outputs. Returns (C→, n) or
    (C→, n, err), and whether the kernel was launched."""
    v_rows, v_cols = torch.as_tensor(v_rows), torch.as_tensor(v_cols)
    small = _single_operands(v_rows, v_cols, acc_rows, acc_cols, p_blk,
                             delta_blk, block_e)
    if v_rows.device.type == "cpu":
        a_r, a_c, p, d = small
        return kref.copyscore_torch(v_rows, p, a_r, s=s, n_false=n_false,
                                    block_e=block_e, v_cols=v_cols,
                                    acc_cols=a_c, delta_blk=d), False
    shape = (v_rows.shape[0], v_cols.shape[0])
    empty = v_rows.shape[1] == 0                 # no entry block: all zero
    outs = tuple((torch.zeros if empty else torch.empty)(
        shape, dtype=torch.float32, device=v_rows.device)
        for _ in range(2 if delta_blk is None else 3))
    if empty:
        return outs, False
    _launch_single(v_rows, v_cols, small, outs, block_e=block_e,
                   accumulate=False, s=s, n_false=n_false)
    return outs, True


def pad_for_copyscore(v: np.ndarray, p_blk: np.ndarray, block_i: int,
                      block_e: int, bucket_sizes=None):
    """Pad the incidence matrix to kernel block multiples (host numpy).

    With ``bucket_sizes`` (entries grouped by representative p) each bucket
    is zero-padded independently to a ``block_e`` multiple, so every entry
    block has one p̂; otherwise entries must already be block-aligned. Rows
    are padded to a ``block_i`` multiple. Zero columns and rows are inert.
    Returns (v_pad, p_blk_pad, S_orig), as the JAX package's does.
    """
    S, E = v.shape
    if bucket_sizes is not None:
        cols, pb = [], []
        off = 0
        for k, size in enumerate(bucket_sizes):
            blk = v[:, off: off + size]
            pad = (-size) % block_e
            if pad:
                blk = np.pad(blk, ((0, 0), (0, pad)))
            cols.append(blk)
            pb.extend([p_blk[k]] * (blk.shape[1] // block_e))
            off += size
        v = np.concatenate(cols, axis=1) if cols else v
        p_blk = np.asarray(pb, dtype=np.float32)
    s_pad = (-S) % block_i
    if s_pad:
        v = np.pad(v, ((0, s_pad), (0, 0)))
    return v, p_blk, S


def copyscore(v, p_blk, acc, *, s: float, n_false: float, block_i: int = 128,
              block_j: int = 128, block_e: int = 512):
    """C_same→ and shared counts over the whole index: the full S×S square,
    each (S, S) float32.

    ``v`` (S, E) incidence with entries bucket-aligned in p (E a multiple of
    ``block_e``; one p̂ per block in ``p_blk``), ``acc`` (S,) accuracies. A
    CPU tensor (or a numpy array) takes ``ref.copyscore_torch``; a CUDA
    tensor launches the hand-written kernel (``csrc/copyscore.cu``, int8
    incidence, ``block_e`` a multiple of 4) or raises. ``block_i`` and
    ``block_j`` are the JAX signature's Pallas tile; the kernels mask ragged
    edges in their own 128×128 tiles, so they change nothing here.
    """
    out, launched = _pair_block(v, v, p_blk, acc, acc, s=s, n_false=n_false,
                                block_e=block_e, delta_blk=None)
    copyscore.launches += launched
    return out


copyscore.launches = 0


def copyscore_tile(v_rows, v_cols, p_blk, acc_rows, acc_cols, *, s: float,
                   n_false: float, block_i: int = 128, block_j: int = 128,
                   block_e: int = 512, delta_blk=None):
    """One rectangular tile of the pair space, rows copy from columns:
    (C_same→, n), or (C_same→, n, err) with ``delta_blk`` (each
    (T_r, T_c) float32) — the per-ordered-tile dataflow that the fused
    kernel replaced, kept as its baseline.

    ``v_rows`` (T_r, E) and ``v_cols`` (T_c, E) incidence, each bucket
    zero-padded to ``block_e`` so that an entry block carries one p̂ (and
    one error bound δ). A CPU tensor takes ``ref.copyscore_torch``; a CUDA
    tensor launches the kernel (``csrc/copyscore.cu``: B2 with
    ``delta_blk``, B3 without) or raises. ``block_i``/``block_j`` as in
    ``copyscore``.
    """
    out, launched = _pair_block(v_rows, v_cols, p_blk, acc_rows, acc_cols,
                                s=s, n_false=n_false, block_e=block_e,
                                delta_blk=delta_blk)
    copyscore_tile.launches += launched
    return out


copyscore_tile.launches = 0


def copyscore_store(store, p_hat, acc, *, s: float, n_false: float,
                    block_i: int = 128, block_j: int = 128):
    """Full-square C_same→ and shared counts streamed from a chunked store:
    (C→, n), each (S, S) float32 on ``acc``'s device.

    Each chunk of ``store`` (a ``core.store.CorpusStore``) is one entry
    block with one representative p̂ (``p_hat[k]``). Where ``acc`` is a CUDA
    tensor, each chunk's int8 block is staged to the card as it is (a chunk
    whose width is not a multiple of 4 gets inert zero columns), and one
    kernel launch adds its sums to the two (S, S) device accumulators — in
    float32, in chunk order, so counts equal one dense ``copyscore`` over
    the same chunks bit for bit. The incidence is resident one chunk at a
    time. Where ``acc`` is a CPU tensor or a numpy array, each chunk goes
    through ``ref.copyscore_torch`` and is added the same way. Chunks with
    no live entry (all-padding columns, which a committed store's region
    alignment or a retraction's GC can leave) add zero to every channel
    and are skipped without a launch. ``block_i``/``block_j`` as in
    ``copyscore``.
    """
    acc = torch.as_tensor(acc)
    dev = acc.device
    acc = _as_blocks(acc, store.n_rows, dev, "acc")
    p_hat = torch.as_tensor(np.asarray(p_hat, np.float32))
    c = torch.zeros((store.n_rows, store.n_rows), dtype=torch.float32,
                    device=dev)
    n = torch.zeros_like(c)
    for k, ch in enumerate(store.iter_chunks()):
        if ch.width == 0 or not (ch.item >= 0).any():
            continue
        V = ch.V
        if dev.type == "cuda" and ch.width % 4:
            V = np.pad(V, ((0, 0), (0, (-ch.width) % 4)))
        v = torch.from_numpy(np.ascontiguousarray(V)).to(dev)
        small = _single_operands(v, v, acc, acc, p_hat[k: k + 1], None,
                                 v.shape[1])
        if dev.type == "cpu":
            ck, nk = kref.copyscore_torch(v, small[2], acc, s=s,
                                          n_false=n_false, block_e=v.shape[1])
            c, n = c + ck, n + nk
            continue
        _launch_single(v, v, small, (c, n), block_e=v.shape[1],
                       accumulate=True, s=s, n_false=n_false)
        copyscore_store.launches += 1
    return c, n


copyscore_store.launches = 0


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_HEAD_DIMS = (64, 128, 256)
_MAX_GRID_Y = 65535


#: source under ``csrc/`` → the name of its error-string function
_FLASH_ERRORS = {"flash_attention_fwd": "flash_attention_error_string",
                 "flash_attention_bwd": "flash_attention_bwd_error_string"}


def _flash_launch(name: str, fn_name: str, n_ptr: int, first, *args) -> None:
    """Launch ``fn_name`` of ``csrc/<name>.cu`` on ``first``'s device and
    current stream. ``args`` are ``n_ptr`` pointers, then integers, then the
    float scale; raise on a non-zero CUDA error code."""
    lib = _build.load(name)
    fn, err = getattr(lib, fn_name), getattr(lib, _FLASH_ERRORS[name])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * (len(args) - n_ptr - 1)
                       + [ctypes.c_float, ctypes.c_void_p])
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        code = fn(*args, stream)
    if code != 0:
        raise RuntimeError(f"{fn_name} failed: {err(code).decode()}")


def _check_qkv(q, k, v, window) -> None:
    """Raise on any operand the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, H, S, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _FLASH_DTYPES or t.dtype != q.dtype:
            raise ValueError(f"q, k, v must share one dtype of float32 or "
                             f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Hq, _, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, Hkv, Sk, D) like q's B and D, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.shape[1] < 1 or Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={k.shape[1]}")
    if D not in _FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {_FLASH_HEAD_DIMS}, got {D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _check_cuda(name: str, *tensors) -> None:
    """Raise unless the operands lie on a CUDA device, aligned for the
    kernels' 16-byte loads, with B·H within the grid."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if q.shape[0] * q.shape[1] > _MAX_GRID_Y:
        raise ValueError(f"B*Hq = {q.shape[0] * q.shape[1]} exceeds the "
                         f"grid's {_MAX_GRID_Y}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: every operand must start on a 16-byte "
                             f"boundary")


def _scale(sm_scale, D: int) -> float:
    return float(sm_scale if sm_scale is not None else 1.0 / (D ** 0.5))


def _window(window) -> int:
    return -1 if window is None else int(window)


@functools.lru_cache(maxsize=256)
def visible_pairs(Sq: int, Sk: int, causal: bool = True, window=None) -> int:
    """(query, key) pairs one head sees: key j is visible from query i iff
    (not causal or j ≤ i) and (window is None or i − j < window), the
    kernels' rule. Causal with Sq = Sk = S and w = min(window, S):
    w(w + 1)/2 + (S − w)·w."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.maximum(i - int(window) + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


#: Products of 2·D operations a visible pair: the forward q·kᵀ and P·v;
#: dq also do·vᵀ; dk/dv the four of the recompute and both gradients.
FLASH_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def flash_counts(which: str, q_shape, k_shape, itemsize: int, *,
                 causal: bool = True, window=None) -> tuple:
    """(operations, bytes) of one call of the forward (``"fwd"``, B4), the
    dq kernel (``"dq"``, B5) or the dk/dv kernel (``"dkv"``, B6) on q
    (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D) of ``itemsize`` bytes an entry.
    Operations: ``FLASH_PRODUCTS[which]`` products of 2·D a visible pair,
    over B·Hq heads. Bytes: each operand read once and each output written
    once — forward q, k, v, o and lse; dq q, do, k, v, lse, delta and dq;
    dk/dv q, do, k, v, lse, delta, dk and dv (lse and delta float32)."""
    B, Hq, Sq, D = (int(x) for x in q_shape)
    Hkv, Sk = int(k_shape[1]), int(k_shape[2])
    pairs = B * Hq * visible_pairs(Sq, Sk, bool(causal),
                                   None if window is None else int(window))
    operations = FLASH_PRODUCTS[which] * 2 * D * pairs
    qb, kvb = itemsize * B * Hq * Sq * D, itemsize * B * Hkv * Sk * D
    stat = 4 * B * Hq * Sq
    nbytes = {"fwd": 2 * qb + 2 * kvb + stat,
              "dq": 3 * qb + 2 * kvb + 2 * stat,
              "dkv": 2 * qb + 4 * kvb + 2 * stat}[which]
    return operations, nbytes


def _flash_meta(which: str, q, k, causal, window) -> None:
    """Report a meta call's ``flash_counts`` (it launches nothing)."""
    ops_n, nbytes = flash_counts(which, q.shape, k.shape, q.element_size(),
                                 causal=causal, window=window)
    record_kernel(f"flash_attention_{which}", ops_n, nbytes)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, sm_scale=None, window=None):
    """Attention forward: (o in q's dtype, lse (B, Hq, Sq) float32).

    q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), contiguous, one dtype (float32 or
    bfloat16), D ∈ {64, 128, 256}, Hq a multiple of Hkv (kv head = q head //
    group). Key j is visible from query i iff (not causal or j ≤ i) and
    (window is None or i − j < window); any Sq and Sk. A CPU tensor takes
    ``ref.flash_attention_fwd_torch``; a CUDA tensor launches the kernel; a
    ``meta`` tensor gives empty outputs and reports ``flash_counts``.
    The kernel's output records no graph, so a CUDA call that would need a
    gradient raises: differentiate through ``flash_attention`` (the
    ``FlashAttention`` Function), whose backward is the two backward
    kernels.
    """
    _check_qkv(q, k, v, window)
    if q.device.type == "cpu":
        return kref.flash_attention_fwd_torch(q, k, v, causal=causal,
                                              sm_scale=sm_scale, window=window)
    if q.device.type != "meta":
        _check_cuda("flash_attention_fwd", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_fwd records no graph on a CUDA tensor; call "
            "ops.flash_attention, whose FlashAttention Function has the "
            "backward kernels")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        _flash_meta("fwd", q, k, causal, window)
        return o, lse
    if q.numel() == 0:
        return o, lse
    _flash_launch("flash_attention_fwd", "flash_attention_fwd_launch", 5, q,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D, _FLASH_DTYPES[q.dtype],
                  int(bool(causal)), _window(window), _scale(sm_scale, D))
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _check_bwd(q, do, **stats) -> None:
    """Raise on a backward operand the kernels do not take: ``do`` like q,
    and each of ``stats`` (lse, delta) (B, Hq, Sq) float32 (q, k, v are
    checked by ``_check_qkv``)."""
    B, Hq, Sq, _ = q.shape
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype:
        raise ValueError(f"do must be like q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in stats.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (B, Hq, Sq):
            raise ValueError(f"{name} must be (B, Hq, Sq) = {(B, Hq, Sq)} "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("do", do), *stats.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           sm_scale=None, window=None) -> torch.Tensor:
    """dq (like q) of the flash-attention backward, from the forward's lse
    and delta = rowsum(do·o), both (B, Hq, Sq) float32. A CPU tensor takes
    ``ref.flash_attention_bwd_dq_torch``; a CUDA tensor launches the dq
    kernel (``csrc/flash_attention_bwd.cu``) or raises; a ``meta`` tensor
    reports ``flash_counts``."""
    _check_qkv(q, k, v, window)
    _check_bwd(q, do, lse=lse, delta=delta)
    kw = dict(causal=causal, sm_scale=sm_scale, window=window)
    if q.device.type == "cpu":
        return kref.flash_attention_bwd_dq_torch(q, k, v, do, lse, delta, **kw)
    if q.device.type == "meta":
        _flash_meta("dq", q, k, causal, window)
        return torch.empty_like(q)
    _check_cuda("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    B, Hq, Sq, D = q.shape
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    _flash_launch("flash_attention_bwd", "flash_attention_bwd_dq_launch", 7, q,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, Hq,
                  k.shape[1], Sq, k.shape[2], D, _FLASH_DTYPES[q.dtype],
                  int(bool(causal)), _window(window), _scale(sm_scale, D))
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            sm_scale=None, window=None):
    """(dk, dv) (like k and v) of the flash-attention backward, summed over
    each kv head's group of q heads. A CPU tensor takes
    ``ref.flash_attention_bwd_dkv_torch``; a CUDA tensor launches the dk/dv
    kernel (``csrc/flash_attention_bwd.cu``) or raises; a ``meta`` tensor
    reports ``flash_counts``."""
    _check_qkv(q, k, v, window)
    _check_bwd(q, do, lse=lse, delta=delta)
    kw = dict(causal=causal, sm_scale=sm_scale, window=window)
    if q.device.type == "cpu":
        return kref.flash_attention_bwd_dkv_torch(q, k, v, do, lse, delta,
                                                  **kw)
    if q.device.type == "meta":
        _flash_meta("dkv", q, k, causal, window)
        return torch.empty_like(k), torch.empty_like(v)
    _check_cuda("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    B, Hq, Sq, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel() == 0:
        return dk, dv
    _flash_launch("flash_attention_bwd", "flash_attention_bwd_dkv_launch", 8,
                  q, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), B, Hq, k.shape[1], Sq, k.shape[2], D,
                  _FLASH_DTYPES[q.dtype], int(bool(causal)), _window(window),
                  _scale(sm_scale, D))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        sm_scale=None, window=None):
    """The flash-attention backward: (dq, dk, dv) in q's, k's and v's dtypes.

    q, o, do (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D) as the forward takes
    them, lse (B, Hq, Sq) float32 from the forward. delta = rowsum(do·o)
    is plain torch in float32 (as the JAX package computes it outside its
    kernels); then ``flash_attention_bwd_dq`` and
    ``flash_attention_bwd_dkv`` run: their kernels on a CUDA tensor, their
    plain versions on a CPU tensor (together
    ``ref.flash_attention_bwd_torch``).
    """
    if tuple(o.shape) != tuple(q.shape) or o.device != q.device:
        raise ValueError(f"o must be like q {tuple(q.shape)} on {q.device}, "
                         f"got {tuple(o.shape)} on {o.device}")
    _check_bwd(q, do, lse=lse)
    kw = dict(causal=causal, sm_scale=sm_scale, window=window)
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, and the two
    backward kernels as its backward (the JAX package's ``custom_vjp`` at
    ``ops.flash_attention``). ``apply(q, k, v, causal, sm_scale, window)``
    returns o; (q, k, v, o, lse) are saved for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, window=window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None


#: From this many query rows on, ``impl="reference"`` takes the chunked
#: form (the JAX package's switch at ``ops.flash_attention``).
CHUNKED_FROM = 8192
#: Query rows a chunk of the chunked form (``ref.attention_chunked``'s).
CHUNK = 2048


def flash_attention(q, k, v, *, causal=True, sm_scale=None, window=None,
                    impl="kernel"):
    """Differentiable attention output o (B, Hq, Sq, D) in q's dtype.

    ``impl="kernel"``: ``FlashAttention`` (the kernels on a CUDA tensor,
    their plain versions on a CPU tensor). ``impl="reference"``: the plain
    ``ref.attention_ref``, or from ``CHUNKED_FROM`` query rows on
    ``ref.attention_chunked`` (O(chunk·Sk) logits, not O(Sq·Sk)).
    ``"chunked"`` and ``"chunked_unroll"`` take ``ref.attention_chunked``
    at every length: chunks of ``CHUNK`` rows (Sq a multiple of it), and
    one chunk of Sq rows below it, where JAX's assert refuses the call (a
    model's prefill and loss then run at any length below 2048 tokens, as
    a model's decode rows and cross attention need). The plain forms are
    differentiated by autograd.
    """
    if impl == "kernel":
        return FlashAttention.apply(q, k, v, causal, sm_scale, window)
    kw = dict(causal=causal, sm_scale=sm_scale, window=window)
    if impl == "reference":
        if q.shape[2] >= CHUNKED_FROM:
            return kref.attention_chunked(q, k, v, **kw)
        return kref.attention_ref(q, k, v, **kw)
    if impl in ("chunked", "chunked_unroll"):
        return kref.attention_chunked(q, k, v, chunk=min(CHUNK, q.shape[2]),
                                      unroll=impl == "chunked_unroll", **kw)
    raise ValueError(f"impl must be 'kernel', 'reference', 'chunked' or "
                     f"'chunked_unroll', got {impl!r}")


__all__ = ["FLASH_PRODUCTS", "FlashAttention", "copyscore", "copyscore_store",
           "copyscore_tile", "copyscore_tile_fused", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_fwd", "flash_counts",
           "pad_for_copyscore", "pair_scores", "tile_scores",
           "visible_pairs"]
