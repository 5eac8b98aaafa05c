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

``flash_attention_fwd``  — attention forward (o, lse) with causal masking,
                           a sliding window and GQA: a CPU tensor takes the
                           plain version (``ref.flash_attention_fwd_torch``);
                           a CUDA tensor launches the hand-written Hopper
                           kernel (``csrc/flash_attention_fwd.cu``) or raises.
``flash_attention``      — the model's attention: ``impl="kernel"`` is
                           ``flash_attention_fwd``'s o, ``impl="reference"``
                           the plain ``ref.attention_ref``.

``tile_scores.launches`` and ``flash_attention_fwd.launches`` count the
kernel launches of this process (plain integers; a caller resets one to 0
to count a run).
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


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535


def _flash_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    return lib


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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, sm_scale=None, window=None):
    """Attention forward: (o in q's dtype, lse (B, Hq, Sq) float32).

    q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), contiguous, one dtype (float32 or
    bfloat16), D ∈ {64, 128}, Hq a multiple of Hkv (kv head = q head //
    group). Key j is visible from query i iff (not causal or j ≤ i) and
    (window is None or i − j < window); any Sq and Sk. A CPU tensor takes
    ``ref.flash_attention_fwd_torch``; a CUDA tensor launches the kernel.
    The kernel has no backward yet: a CUDA call that would need a gradient
    raises.
    """
    _check_qkv(q, k, v, window)
    if q.device.type == "cpu":
        return kref.flash_attention_fwd_torch(q, k, v, causal=causal,
                                              sm_scale=sm_scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cpu or cuda, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention kernel has no backward yet (ROADMAP B5)")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if B * Hq > _MAX_GRID_Y:
        raise ValueError(f"B*Hq = {B * Hq} exceeds the grid's {_MAX_GRID_Y}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)
    lib = _flash_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D, _FLASH_DTYPES[q.dtype],
            int(bool(causal)), -1 if window is None else int(window),
            float(scale), stream)
    if code != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{lib.flash_attention_error_string(code).decode()}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, causal=True, sm_scale=None, window=None,
                    impl="kernel"):
    """Attention output o (B, Hq, Sq, D) in q's dtype.

    ``impl="kernel"``: ``flash_attention_fwd`` (the kernel on a CUDA tensor,
    its plain version on a CPU tensor). ``impl="reference"``: the plain
    ``ref.attention_ref``.
    """
    if impl == "kernel":
        return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                   window=window)[0]
    if impl == "reference":
        return kref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                  window=window)
    raise ValueError(f"impl must be 'kernel' or 'reference', got {impl!r}")


__all__ = ["copyscore_tile_fused", "flash_attention", "flash_attention_fwd",
           "tile_scores"]
