"""Shared model components: norms, RoPE, initializers, dtype policy.

Parameters are plain nested dicts (and lists) of tensors in the JAX
package's layout. Random initializers draw from an explicit
``torch.Generator`` on the parameters' device; they give other numbers than
``jax.random`` from the same seed, so the tests carry the JAX parameters
across (``models.model.params_from_jax``) instead.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rms_norm(x, weight, eps: float = 1e-6):
    """RMS norm with a ``(1 + w)`` scale, computed in float32 and cast back."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dt)


def make_rope(positions, head_dim: int, theta: float = 10000.0, device=None):
    """(cos, sin) of shape (len(positions), head_dim // 2), float32."""
    pos = torch.as_tensor(positions, device=device).to(torch.float32)
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=pos.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = torch.outer(pos.reshape(-1), freqs)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, head_dim); cos/sin (S, head_dim/2) or broadcastable. The
    tables are cast to x's dtype first, as the JAX package does."""
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def dense_init(gen: torch.Generator, shape, in_axis_size=None,
               dtype=torch.float32):
    """Normal weights scaled by 1/sqrt(fan_in), on ``gen``'s device."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=gen.device) * scale


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def stacked(init_fn, gen: torch.Generator, n: int, *args, **kw):
    """Initialize a weight tree stacked over a leading layer dimension: one
    draw of ``init_fn`` per layer, in layer order."""
    layers = [init_fn(gen, *args, **kw) for _ in range(n)]

    def zip_trees(trees):
        if isinstance(trees[0], dict):
            return {k: zip_trees([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return zip_trees(layers)


def cast_tree(tree, dtype):
    """Every floating-point leaf cast to ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)
