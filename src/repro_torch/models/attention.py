"""Self/cross attention with GQA, RoPE, sliding windows, QKV bias and KV
caching.

Layouts (the JAX package's):
  weights  wq (D, H, hd) · wk/wv (D, KV, hd) · wo (H, hd, D); cross
           attention's wk/wv read cond_dim (cond_dim, KV, hd); with
           ``cfg.qkv_bias`` also bq (H, hd) · bk/bv (KV, hd)
  cache    k/v (B, KV, S_cache, hd) + pos_ids (B, S_cache) absolute positions
           (pos_ids makes rotating sliding-window caches maskable).
The prefill/forward attention goes through ``kernels.ops.flash_attention``
(``cfg.attention_impl``: the hand-written kernel, or the plain reference).
One-token decode self attention is plain torch, as the JAX package leaves
it to jnp. Cross attention (not causal, no RoPE) goes through
``flash_attention`` in prefill and decode alike; as in the JAX package,
nothing caches the conditioning's k/v, which each call projects again.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import apply_rope, dense_init, make_rope


def init_attention(gen: torch.Generator, cfg: ModelConfig, cross: bool = False):
    D = cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kv_in = cfg.cond_dim if cross else D
    p = {
        "wq": dense_init(gen, (D, H, hd), in_axis_size=D),
        "wk": dense_init(gen, (kv_in, KV, hd), in_axis_size=kv_in),
        "wv": dense_init(gen, (kv_in, KV, hd), in_axis_size=kv_in),
        "wo": dense_init(gen, (H, hd, D), in_axis_size=H * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), device=gen.device)
        p["bk"] = torch.zeros((KV, hd), device=gen.device)
        p["bv"] = torch.zeros((KV, hd), device=gen.device)
    return p


def attention_dims(cfg: ModelConfig, cross: bool = False):
    """Logical dims of ``init_attention``'s leaves (``runtime/sharding.py``)."""
    kv_in = "cond_dim" if cross else "d_model"
    d = {
        "wq": ("d_model", "heads", "head_dim"),
        "wk": (kv_in, "kv_heads", "head_dim"),
        "wv": (kv_in, "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "d_model"),
    }
    if cfg.qkv_bias:
        d["bq"] = ("heads", "head_dim")
        d["bk"] = ("kv_heads", "head_dim")
        d["bv"] = ("kv_heads", "head_dim")
    return d


def _project_qkv(p, x, kv_src, cfg: ModelConfig):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bhsk", kv_src, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bhsk", kv_src, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)[None, :, None, :]
        k = k + p["bk"].to(dt)[None, :, None, :]
        v = v + p["bv"].to(dt)[None, :, None, :]
    return q, k, v


def self_attention(p, x, rope, cfg: ModelConfig, window: Optional[int] = None):
    """Training/prefill forward. x (B, S, D) → (B, S, D), causal."""
    cos, sin = rope
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True, window=window, impl=cfg.attention_impl)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))


def cross_attention(p, x, cond, cfg: ModelConfig):
    """x (B, S, D) attends over cond (B, T, cond_dim); not causal, no rope.
    The prefill (S query rows) and the decode step (one) alike."""
    q, k, v = _project_qkv(p, x, cond, cfg)
    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=False, impl=cfg.attention_impl)
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


def kv_cache_dims():
    """Logical dims of ``init_kv_cache``'s leaves."""
    return {
        "k": ("layer", "batch", "kv_heads", "seq", "head_dim"),
        "v": ("layer", "batch", "kv_heads", "seq", "head_dim"),
        "pos_ids": ("layer", "batch", "seq"),
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
    q, k_new, v_new = _project_qkv(p, x, x, cfg)  # (B,H,1,hd), (B,KV,1,hd)
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
