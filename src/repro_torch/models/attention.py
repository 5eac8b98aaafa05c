"""Self attention with GQA, RoPE, sliding windows, and KV caching.

Layouts (the JAX package's):
  weights  wq (D, H, hd) · wk/wv (D, KV, hd) · wo (H, hd, D)
  cache    k/v (B, KV, S_cache, hd) + pos_ids (B, S_cache) absolute positions
           (pos_ids makes rotating sliding-window caches maskable).
The prefill/forward attention goes through ``kernels.ops.flash_attention``
(``cfg.attention_impl``: the hand-written kernel, or the plain reference).
One-token decode attention is plain torch, as the JAX package leaves it to
jnp. ``cross_attention`` waits for the ``cross`` block kind (ROADMAP A14).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import apply_rope, dense_init, make_rope


def init_attention(gen: torch.Generator, cfg: ModelConfig):
    D = cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (D, H, hd), in_axis_size=D),
        "wk": dense_init(gen, (D, KV, hd), in_axis_size=D),
        "wv": dense_init(gen, (D, KV, hd), in_axis_size=D),
        "wo": dense_init(gen, (H, hd, D), in_axis_size=H * hd),
    }


def _project_qkv(p, x):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(dt))
    return q, k, v


def self_attention(p, x, rope, cfg: ModelConfig, window: Optional[int] = None):
    """Training/prefill forward. x (B, S, D) → (B, S, D), causal."""
    cos, sin = rope
    q, k, v = _project_qkv(p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True, window=window, impl=cfg.attention_impl)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# decoding with a KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, seq_len: int,
                  window: Optional[int] = None, dtype=torch.bfloat16,
                  device=None):
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    S = min(seq_len, window) if window else seq_len
    return {
        "k": torch.zeros((n_layers, batch, KV, S, hd), dtype=dtype, device=device),
        "v": torch.zeros((n_layers, batch, KV, S, hd), dtype=dtype, device=device),
        # per-row absolute positions: rows may decode at different positions
        # (continuous batching, runtime/serve_loop.py)
        "pos_ids": torch.full((n_layers, batch, S), -1, dtype=torch.int32,
                              device=device),
    }


def decode_self_attention(p, x, cache_l, pos, cfg: ModelConfig,
                          window: Optional[int] = None):
    """One-token decode. x (B, 1, D); cache_l holds this layer's k/v/pos_ids.

    ``pos`` is a Python int (every row at one position) or a (B,) integer
    tensor (per-row positions, continuous batching). Returns (out (B,1,D),
    cache_l). The cache slot is pos % S_cache (rotating for sliding windows,
    identity otherwise); masking uses the stored absolute positions so SWA
    and full caches share one code path. Unlike the JAX package, which
    returns a new cache, the port writes the new k/v/pos_ids into
    ``cache_l``'s tensors in place (no copy of the whole cache per step) and
    returns the same dict.
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x)        # (B,H,1,hd), (B,KV,1,hd)
    k, v, pos_ids = cache_l["k"], cache_l["v"], cache_l["pos_ids"]
    S_c = k.shape[2]
    hd = cfg.resolved_head_dim

    if isinstance(pos, torch.Tensor) and pos.dim() > 0:   # per-row positions
        pos = pos.to(device=x.device, dtype=torch.long)
        cos, sin = make_rope(pos, hd, cfg.rope_theta)
        cos = cos[:, None, None, :]                  # (B,1,1,hd/2)
        sin = sin[:, None, None, :]
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
        rows = torch.arange(B, device=x.device)
        slot = pos % S_c
        k[rows, :, slot] = k_new[:, :, 0].to(k.dtype)
        v[rows, :, slot] = v_new[:, :, 0].to(v.dtype)
        pos_ids[rows, slot] = pos.to(pos_ids.dtype)
        pos_b = pos[:, None]                         # (B,1)
    else:                                            # one shared position
        pos = int(pos)
        cos, sin = make_rope([pos], hd, cfg.rope_theta, device=x.device)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
        slot = pos % S_c
        k[:, :, slot] = k_new[:, :, 0].to(k.dtype)
        v[:, :, slot] = v_new[:, :, 0].to(v.dtype)
        pos_ids[:, slot] = pos
        pos_b = torch.full((B, 1), pos, dtype=torch.long, device=x.device)

    scale = 1.0 / (hd ** 0.5)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    group = H // KV
    qg = q.reshape(B, KV, group, hd)
    logits = torch.einsum("bkgd,bksd->bkgs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    valid = (pos_ids >= 0) & (pos_ids <= pos_b)      # (B, S_c)
    if window is not None:
        valid &= (pos_b - pos_ids) < window
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", probs, v.to(torch.float32))
    o = o.reshape(B, H, 1, hd).to(x.dtype)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache_l
