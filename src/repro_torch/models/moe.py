"""Mixture-of-experts FFN with top-k routing and per-expert capacity: the
JAX package's ``models/moe.py``.

Dispatch is gather-based (no T×E×C one-hot tensors): tokens are assigned
positional slots within their expert's capacity buffer by a cumulative
count, so the earliest tokens are kept and the overflow is dropped
(``capacity_factor`` controls the slack). Unfilled slots gather token 0
and add a zero contribution. The expert loop runs one expert at a time and
casts only that expert's weights to the compute dtype, as JAX's
``lax.scan`` keeps one expert's buffer live; its products stay
``torch.matmul``, as JAX computes them outside any Pallas kernel.

Numerics as in JAX: the router's logits in the compute dtype, their
softmax in float32, top-k with ties broken to the lower expert index (as
``lax.top_k``; ``torch.topk`` leaves the order of equals unspecified), the
top-k weights renormalised, the gated product in the compute dtype scaled
by the routing weight cast to it, and each expert's contribution added in
expert order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, (D, E)),
        "wg": dense_init(gen, (E, D, F_), in_axis_size=D),
        "wu": dense_init(gen, (E, D, F_), in_axis_size=D),
        "wd": dense_init(gen, (E, F_, D), in_axis_size=F_),
    }


def moe_dims(cfg: ModelConfig):
    """Logical dims of ``init_moe``'s leaves (``runtime/sharding.py``)."""
    return {
        "router": ("d_model", "experts"),
        "wg": ("experts", "d_model", "d_ff"),
        "wu": ("experts", "d_model", "d_ff"),
        "wd": ("experts", "d_ff", "d_model"),
    }


def route(p, x, k: int):
    """Top-k routing of x (..., D): (weights, experts), each (..., k); the
    weights renormalised to sum to 1, equal probabilities ordered by expert
    index."""
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return vals / vals.sum(dim=-1, keepdim=True), idx


def _slots(w_tok, capacity: int):
    """w_tok (R, N) routing weights of one expert over R rows of N tokens →
    (buf (R, C) token indices, w_sel (R, C) their weights, 0 where a slot
    is unfilled): the first ``capacity`` tokens with a weight, in order."""
    R, N = w_tok.shape
    mask = w_tok > 0.0
    pos = torch.cumsum(mask, dim=-1) - 1
    keep = mask & (pos < capacity)
    slot = torch.where(keep, pos, capacity)
    buf = torch.zeros((R, capacity + 1), dtype=torch.long, device=w_tok.device)
    buf.scatter_(1, slot, torch.arange(N, device=w_tok.device).expand(R, N))
    buf = buf[:, :capacity]
    n_keep = keep.sum(dim=-1, keepdim=True)
    valid = torch.arange(capacity, device=w_tok.device) < n_keep
    w_sel = torch.where(valid, torch.gather(w_tok, 1, buf), 0.0)
    return buf, w_sel


def _experts(p, x, top_vals, top_idx, capacity: int):
    """x (R, N, D) rows of tokens routed by (top_vals, top_idx) (R, N, k):
    the sum over experts of each expert's gated product on its ≤ capacity
    tokens a row, weighted. Returns (R, N, D) in x's dtype."""
    R, N, D = x.shape
    dt = x.dtype
    y = torch.zeros_like(x)
    y_flat = y.view(R * N, D)
    row0 = (torch.arange(R, device=x.device) * N)[:, None]
    for e in range(p["wg"].shape[0]):
        w_tok = torch.where(top_idx == e, top_vals, 0.0).sum(dim=-1)  # (R, N)
        buf, w_sel = _slots(w_tok, capacity)
        flat = (row0 + buf).reshape(-1)                             # (R·C,)
        xe = x.reshape(R * N, D)[flat]
        act = F.silu(xe @ p["wg"][e].to(dt)) * (xe @ p["wu"][e].to(dt))
        ye = act @ p["wd"][e].to(dt)
        y_flat.index_add_(0, flat, ye * w_sel.reshape(-1, 1).to(dt))
    return y


def moe_forward(p, x, cfg: ModelConfig):
    """x (B, S, D) → (B, S, D). Row-local routing (the default: capacity
    ⌈cf·k·S/E⌉ per batch row) or global routing over all B·S tokens
    (``cfg.moe_routing == "global"``, capacity ⌈cf·k·T/E⌉)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    rows = x if cfg.moe_routing != "global" else x.reshape(1, B * S, D)
    N = rows.shape[1]
    capacity = min(int(math.ceil(cfg.capacity_factor * k * N / E)), N)
    top_vals, top_idx = route(p, rows, k)
    return _experts(p, rows, top_vals, top_idx, capacity).reshape(B, S, D)
