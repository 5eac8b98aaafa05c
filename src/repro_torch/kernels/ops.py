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

``tile_scores.launches`` counts the kernel launches of this process (a plain
integer; a caller resets it to 0 to count a run).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref

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


__all__ = ["copyscore_tile_fused", "tile_scores"]
