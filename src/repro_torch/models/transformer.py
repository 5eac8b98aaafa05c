"""Block definitions and segment runners.

A model is a sequence of homogeneous *segments* (configs/base.py layer
plan); each segment's per-layer parameters are stacked on a leading dim.
The JAX package runs a segment with ``lax.scan``; the port runs a Python
loop over the stacked layer dimension. With ``cfg.remat`` each layer runs
under ``torch.utils.checkpoint`` (the counterpart of the JAX package's
``jax.checkpoint``) whenever autograd records a graph: only the layer's
input is kept, and the backward recomputes the layer's forward. The port
serves and trains every block kind of the JAX package (``dense``,
``moe``, ``cross``, ``ssm``, ``hybrid_swa``, ``hybrid_full``): the scan's
backward is ``mamba.SelectiveScan``, the expert loop's and the cross
attention's are autograd through its gathers and ``index_add_`` and
through the flash-attention Function.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    attention_dims,
    cross_attention,
    decode_self_attention,
    init_attention,
    init_kv_cache,
    kv_cache_dims,
    self_attention,
)
from repro_torch.models.common import is_dims, rms_norm, stacked, tree_map
from repro_torch.models.mamba import (
    init_mamba,
    init_ssm_cache,
    mamba_decode_step,
    mamba_dims,
    mamba_forward,
    ssm_cache_dims,
)
from repro_torch.models.mlp import init_mlp, mlp_dims, mlp_forward
from repro_torch.models.moe import init_moe, moe_dims, moe_forward

PORTED_KINDS = ("dense", "moe", "cross", "ssm", "hybrid_swa", "hybrid_full")
ATTN_KINDS = {"dense", "moe", "cross", "hybrid_swa", "hybrid_full"}
SSM_KINDS = {"ssm", "hybrid_swa", "hybrid_full"}


def check_kind(kind: str) -> None:
    """Raise for a block kind the port does not run."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported (ROADMAP A.7); the port "
            f"runs {PORTED_KINDS}")


def _window(kind: str, cfg: ModelConfig) -> Optional[int]:
    return cfg.swa_window if kind == "hybrid_swa" else None


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------

def init_block(gen, kind: str, cfg: ModelConfig):
    check_kind(kind)

    def zeros():
        return torch.zeros((cfg.d_model,), device=gen.device)

    p = {"norm1": zeros()}
    if kind in ATTN_KINDS:
        p["attn"] = init_attention(gen, cfg)
    if kind == "cross":
        p["xattn"] = init_attention(gen, cfg, cross=True)
        p["norm_x"] = zeros()
    if kind in SSM_KINDS:
        p["mamba"] = init_mamba(gen, cfg)
    if kind.startswith("hybrid"):
        p["norm_a"] = zeros()
        p["norm_m"] = zeros()
    if kind == "moe":
        p["moe"] = init_moe(gen, cfg)
        p["norm2"] = zeros()
    elif kind != "ssm":                                  # dense/cross/hybrid MLP
        p["mlp"] = init_mlp(gen, cfg)
        p["norm2"] = zeros()
    return p


def block_dims(kind: str, cfg: ModelConfig):
    """Logical dims of ``init_block``'s leaves (``runtime/sharding.py``)."""
    check_kind(kind)
    d = {"norm1": ("d_model",)}
    if kind in ATTN_KINDS:
        d["attn"] = attention_dims(cfg)
    if kind == "cross":
        d["xattn"] = attention_dims(cfg, cross=True)
        d["norm_x"] = ("d_model",)
    if kind in SSM_KINDS:
        d["mamba"] = mamba_dims(cfg)
    if kind.startswith("hybrid"):
        d["norm_a"] = ("d_model",)
        d["norm_m"] = ("d_model",)
    if kind == "moe":
        d["moe"] = moe_dims(cfg)
        d["norm2"] = ("d_model",)
    elif kind != "ssm":
        d["mlp"] = mlp_dims(cfg)
        d["norm2"] = ("d_model",)
    return d


def init_segment(gen, kind: str, count: int, cfg: ModelConfig):
    return stacked(lambda g: init_block(g, kind, cfg), gen, count)


def segment_dims(kind: str, cfg: ModelConfig):
    """``block_dims`` with the segment's leading ``layer`` dim."""
    return tree_map(lambda dims: ("layer",) + dims, block_dims(kind, cfg),
                    is_leaf=is_dims)


def _layer(seg_params, i: int):
    """Layer ``i``'s slice of a stacked parameter (or cache) tree."""
    if isinstance(seg_params, dict):
        return {k: _layer(v, i) for k, v in seg_params.items()}
    return seg_params[i]


def _n_layers(seg_params) -> int:
    return int(seg_params["norm1"].shape[0])


def _unstack(seg_params):
    """Per-layer trees of a stacked tree, through one ``torch.unbind`` per
    leaf: a backward then gathers each leaf's layer gradients with one
    stack, where indexing layer by layer would add a zero-filled copy of
    the whole stacked leaf per layer."""
    if isinstance(seg_params, dict):
        per_key = {k: _unstack(v) for k, v in seg_params.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return torch.unbind(seg_params)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def block_forward(kind: str, p, x, rope, cfg: ModelConfig, cond=None):
    check_kind(kind)
    h = rms_norm(x, p["norm1"])
    if kind == "ssm":
        return x + mamba_forward(p["mamba"], h, cfg)
    if kind.startswith("hybrid"):
        a = self_attention(p["attn"], h, rope, cfg, window=_window(kind, cfg))
        m = mamba_forward(p["mamba"], h, cfg)
        x = x + 0.5 * (rms_norm(a, p["norm_a"]) + rms_norm(m, p["norm_m"]))
    else:
        x = x + self_attention(p["attn"], h, rope, cfg)
    return _cross_and_ffn(kind, p, x, cond, cfg)


def _cross_and_ffn(kind: str, p, x, cond, cfg: ModelConfig):
    """The block's tail after self attention, shared by the prefill and
    the decode step: cross attention (``cross``), then the MoE FFN or the
    MLP."""
    if kind == "cross":
        x = x + cross_attention(p["xattn"], rms_norm(x, p["norm_x"]), cond, cfg)
    ff_in = rms_norm(x, p["norm2"])
    if kind == "moe":
        return x + moe_forward(p["moe"], ff_in, cfg)
    return x + mlp_forward(p["mlp"], ff_in, cfg)


def run_segment(kind: str, seg_params, x, rope, cfg: ModelConfig, cond=None):
    remat = cfg.remat and torch.is_grad_enabled()
    for p_l in _unstack(seg_params):
        if remat:
            x = checkpoint(block_forward, kind, p_l, x, rope, cfg, cond,
                           use_reentrant=False)
        else:
            x = block_forward(kind, p_l, x, rope, cfg, cond)
    return x


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def init_segment_cache(kind: str, count: int, cfg: ModelConfig, batch: int,
                       seq_len: int, dtype=torch.bfloat16, device=None):
    check_kind(kind)
    c = {}
    if kind in ATTN_KINDS:
        c["kv"] = init_kv_cache(cfg, count, batch, seq_len,
                                window=_window(kind, cfg), dtype=dtype,
                                device=device)
    if kind in SSM_KINDS:
        c["ssm"] = init_ssm_cache(cfg, count, batch, dtype=dtype, device=device)
    return c


def segment_cache_dims(kind: str):
    """Logical dims of ``init_segment_cache``'s leaves."""
    c = {}
    if kind in ATTN_KINDS:
        c["kv"] = kv_cache_dims()
    if kind in SSM_KINDS:
        c["ssm"] = ssm_cache_dims()
    return c


def block_decode(kind: str, p, x, cache_l, pos, cfg: ModelConfig, cond=None):
    """x (B,1,D) one-token step. cache_l: this layer's slice (no leading L),
    updated in place."""
    check_kind(kind)
    h = rms_norm(x, p["norm1"])
    if kind == "ssm":
        o, _ = mamba_decode_step(p["mamba"], h, cache_l["ssm"], cfg)
        return x + o, cache_l
    if kind.startswith("hybrid"):
        a, _ = decode_self_attention(p["attn"], h, cache_l["kv"], pos, cfg,
                                     window=_window(kind, cfg))
        m, _ = mamba_decode_step(p["mamba"], h, cache_l["ssm"], cfg)
        x = x + 0.5 * (rms_norm(a, p["norm_a"]) + rms_norm(m, p["norm_m"]))
    else:
        a, _ = decode_self_attention(p["attn"], h, cache_l["kv"], pos, cfg)
        x = x + a
    return _cross_and_ffn(kind, p, x, cond, cfg), cache_l


def run_segment_decode(kind: str, seg_params, x, cache, pos, cfg: ModelConfig,
                       cond=None):
    """One decode step through a segment; ``cache`` is updated in place and
    returned."""
    for i in range(_n_layers(seg_params)):
        x, _ = block_decode(kind, _layer(seg_params, i), x, _layer(cache, i),
                            pos, cfg, cond)
    return x, cache
