"""Shared model components: norms, RoPE, initializers, dtype policy.

Parameters are plain nested dicts (and lists) of tensors in the JAX
package's layout. Random initializers draw from an explicit
``torch.Generator`` on the parameters' device; they give other numbers than
``jax.random`` from the same seed, so the tests carry the JAX parameters
across (``models.model.params_from_jax``) instead. On the ``meta``
device a ``MetaGenerator`` takes the generator's place, so a model's
shapes come without memory (``runtime/sharding.py`` sizes grok-1 so).
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


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where parameters are made on the
    ``meta`` device (``torch.Generator`` has none): the initializers then
    give tensors of the right shapes and dtypes, with no memory and no
    draws."""

    device = torch.device("meta")


def randn(gen, shape, dtype=torch.float32):
    """Standard normal draws from ``gen`` on its device; on a
    ``MetaGenerator``, a meta tensor of that shape."""
    draws = None if gen.device.type == "meta" else gen
    return torch.randn(tuple(shape), generator=draws, dtype=dtype,
                       device=gen.device)


def dense_init(gen, shape, in_axis_size=None, dtype=torch.float32):
    """Normal weights scaled by 1/sqrt(fan_in), on ``gen``'s device (a
    meta tensor is left unscaled: it has no values, and the product costs
    more on ``meta`` than the draw)."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = randn(gen, shape, dtype)
    return w if w.is_meta else w * scale


def is_dims(x) -> bool:
    """A leaf of a logical-dims tree or a sharding spec: a tuple of axis
    names, ``None`` or tuples of names (JAX's ``is_leaf`` for them)."""
    return isinstance(x, tuple) and all(
        d is None or isinstance(d, str)
        or (isinstance(d, tuple) and all(isinstance(a, str) for a in d))
        for d in x)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` applied to every leaf of a tree of dicts and lists (and
    tuples, unless ``is_leaf`` takes them). Trees in ``rest`` are walked
    alongside: ``fn(leaf, *their subtrees at its place)``, as
    ``jax.tree.map`` with several trees."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists in the JAX package's order:
    dict keys sorted, list items in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def stacked(init_fn, gen: torch.Generator, n: int, *args, **kw):
    """Initialize a weight tree stacked over a leading layer dimension: one
    draw of ``init_fn`` per layer, in layer order, each written into the
    stacked leaves as soon as it is drawn (so the peak is the stack and one
    layer, not the stack twice)."""
    out = None
    for i in range(n):
        layer = init_fn(gen, *args, **kw)
        if out is None:
            out = tree_map(lambda t: t.new_empty((n, *t.shape)), layer)
        _put(out, layer, i)
    return out


def _put(dst, src, i: int) -> None:
    if isinstance(src, dict):
        for k in src:
            _put(dst[k], src[k], i)
    else:
        dst[i] = src


def cast_tree(tree, dtype):
    """Every floating-point leaf cast to ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)
