"""Block definitions and segment runners.

A model is a sequence of homogeneous *segments* (configs/base.py layer
plan); each segment's per-layer parameters are stacked on a leading dim.
The JAX package runs a segment with ``lax.scan``; the port runs a Python
loop over the stacked layer dimension. With ``cfg.remat`` each layer runs
under ``torch.utils.checkpoint`` (the counterpart of the JAX package's
``jax.checkpoint``) whenever autograd records a graph: only the layer's
input is kept, and the backward recomputes the layer's forward. The port
runs the ``dense`` block kind; every other kind raises
``NotImplementedError`` until it is ported (ROADMAP A14).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    decode_self_attention,
    init_attention,
    init_kv_cache,
    self_attention,
)
from repro_torch.models.common import rms_norm, stacked
from repro_torch.models.mlp import init_mlp, mlp_forward

PORTED_KINDS = ("dense",)


def check_kind(kind: str) -> None:
    """Raise for a block kind the port does not run yet."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP A14); the port "
            f"runs {PORTED_KINDS}")


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, kind: str, cfg: ModelConfig):
    check_kind(kind)
    dev = gen.device
    return {
        "norm1": torch.zeros((cfg.d_model,), device=dev),
        "attn": init_attention(gen, cfg),
        "mlp": init_mlp(gen, cfg),
        "norm2": torch.zeros((cfg.d_model,), device=dev),
    }


def init_segment(gen: torch.Generator, kind: str, count: int, cfg: ModelConfig):
    return stacked(lambda g: init_block(g, kind, cfg), gen, count)


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

def block_forward(kind: str, p, x, rope, cfg: ModelConfig):
    check_kind(kind)
    h = rms_norm(x, p["norm1"])
    x = x + self_attention(p["attn"], h, rope, cfg)
    ff_in = rms_norm(x, p["norm2"])
    return x + mlp_forward(p["mlp"], ff_in)


def run_segment(kind: str, seg_params, x, rope, cfg: ModelConfig):
    remat = cfg.remat and torch.is_grad_enabled()
    for p_l in _unstack(seg_params):
        if remat:
            x = checkpoint(block_forward, kind, p_l, x, rope, cfg,
                           use_reentrant=False)
        else:
            x = block_forward(kind, p_l, x, rope, cfg)
    return x


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def init_segment_cache(kind: str, count: int, cfg: ModelConfig, batch: int,
                       seq_len: int, dtype=torch.bfloat16, device=None):
    check_kind(kind)
    return {"kv": init_kv_cache(cfg, count, batch, seq_len, dtype=dtype,
                                device=device)}


def block_decode(kind: str, p, x, cache_l, pos, cfg: ModelConfig):
    """x (B,1,D) one-token step. cache_l: this layer's slice (no leading L),
    updated in place."""
    check_kind(kind)
    h = rms_norm(x, p["norm1"])
    a, kv = decode_self_attention(p["attn"], h, cache_l["kv"], pos, cfg)
    x = x + a
    ff_in = rms_norm(x, p["norm2"])
    return x + mlp_forward(p["mlp"], ff_in), {"kv": kv}


def run_segment_decode(kind: str, seg_params, x, cache, pos, cfg: ModelConfig):
    """One decode step through a segment; ``cache`` is updated in place and
    returned."""
    for i in range(_n_layers(seg_params)):
        x, _ = block_decode(kind, _layer(seg_params, i), x, _layer(cache, i),
                            pos, cfg)
    return x, cache
