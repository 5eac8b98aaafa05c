"""Adafactor (factored second moment) on parameter trees.

The port of the JAX package's ``optim/adafactor.py``: the same defaults
(``decay`` 0.99 with no step dependence, ``eps`` 1e-30, ``clip_threshold``
1.0, ``weight_decay`` 0.0) and the same update, in float32,
    g2 = g·g + eps,
    a leaf of ≥ 2 dims:  vr ← decay·vr + (1 − decay)·mean(g2, −1),
                         vc ← decay·vc + (1 − decay)·mean(g2, −2),
                         denom = vr ⊗ vc / max(mean(vr, −1), eps),
    a 1-D leaf:          v ← decay·v + (1 − decay)·g2,  denom = v,
    u = g·rsqrt(denom + eps),  u ← u / max(1, rms(u) / clip_threshold),
    u ← u + wd·master,  master ← master − lr·u,  param ← master,
with rms(u) = √(mean(u²) + eps) over the whole leaf. The factors are over
the last two axes, so the ≥ 2-dim state is O(n + m) a matrix where a full
second moment is O(n·m). When any parameter is bf16 the state holds a
float32 ``master`` copy of every parameter.

As the port's AdamW, ``update`` writes the new factors, masters and
parameters into the given tensors and returns the same trees.
``torch.optim.Adafactor`` is not used: its state layout, relative step
and clipping differ.

Memory: a stacked leaf of ≥ 3 dims (a segment's (L, …, m, n) weights) is
never copied whole into a float32 temporary. Its leading dims are batch
dims of the factors (each (m, n) matrix has its own vr, vc and
mean(vr)), so the update runs matrix by matrix in two passes: the first
updates the factors and sums u², the second computes u again and applies
it, clipped by the whole leaf's RMS. A 2-D leaf is one matrix, updated
whole: a stacked (L, d) leaf (norm scales, biases) is factored across its
layers, as in JAX. ``adafactor_ref`` is the plain whole-leaf update, the
check of the sliced one.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import is_dims, tree_leaves, tree_map
from repro_torch.optim.adamw import Optimizer


def _factors(p):
    if p.ndim >= 2:
        return {"vr": _zeros(p.shape[:-1], p),
                "vc": _zeros(p.shape[:-2] + p.shape[-1:], p)}
    return {"v": _zeros(p.shape, p)}


def _state_dims(param_dims, has_master=False):
    """The state's logical dims: a ≥ 2-dim leaf's ``vr`` drops its last
    dim and ``vc`` its second to last, a 1-dim leaf's ``v`` keeps its."""
    def fdims(d):
        if len(d) >= 2:
            return {"vr": tuple(d[:-1]), "vc": tuple(d[:-2]) + (d[-1],)}
        return {"v": tuple(d)}

    d = {"f": tree_map(fdims, param_dims, is_leaf=is_dims)}
    if has_master:
        d["master"] = param_dims
    return d


def _zeros(shape, p):
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def _init(params):
    state = {"f": tree_map(_factors, params)}
    if any(p.dtype == torch.bfloat16 for p in tree_leaves(params)):
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def _paired(tree, other):
    """(leaf of ``tree``, the subtree of ``other`` at its place), in
    ``tree_leaves`` order: each parameter with its factors."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paired(tree[k], other[k])
    elif isinstance(tree, (list, tuple)):
        for a, b in zip(tree, other):
            yield from _paired(a, b)
    else:
        yield tree, other


def _leaves(grads, state, params):
    """(g, factors, param, master) for every leaf."""
    masters = tree_leaves(state.get("master", params))
    pairs = list(_paired(params, state["f"]))
    return [(g, f, p, w) for g, (p, f), w in
            zip(tree_leaves(grads), pairs, masters)]


def _apply(u, p, w, lr, weight_decay):
    """master ← master − lr·(u + wd·master); the parameter follows it."""
    if weight_decay:
        u.add_(w, alpha=weight_decay)
    w.sub_(lr * u)
    if w is not p:
        p.copy_(w)


def adafactor(decay=0.99, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0) -> Optimizer:
    """The sliced, in-place update described in the module docstring."""

    def matrix_u(g, vr, vc):
        """u of one (m, n) matrix from its updated factors."""
        scale = vr.mean().clamp(min=eps)
        return torch.outer(vr, vc).div_(scale).add_(eps).rsqrt_().mul_(g)

    def update_matrices(g, f, p, w, lr):
        m, n = p.shape[-2:]
        g3 = g.reshape(-1, m, n)
        vr3, vc3 = f["vr"].view(-1, m), f["vc"].view(-1, n)
        p3, w3 = p.view(-1, m, n), w.view(-1, m, n)
        one = g3.shape[0] == 1          # a 2-D leaf: keep u, no second pass
        sumsq = torch.zeros((), dtype=torch.float32, device=p.device)
        kept = None
        for i in range(g3.shape[0]):
            gi = g3[i].to(torch.float32)
            g2 = (gi * gi).add_(eps)
            vr3[i].mul_(decay).add_(g2.mean(dim=-1), alpha=1 - decay)
            vc3[i].mul_(decay).add_(g2.mean(dim=-2), alpha=1 - decay)
            del g2
            u = matrix_u(gi, vr3[i], vc3[i])
            sumsq += torch.sum(u * u)
            if one:
                kept = u
        div = torch.clamp(torch.sqrt(sumsq / g.numel() + eps) / clip_threshold,
                          min=1.0)
        for i in range(g3.shape[0]):
            u = kept if one else matrix_u(g3[i].to(torch.float32), vr3[i], vc3[i])
            _apply(u.div_(div), p3[i], w3[i], lr, weight_decay)

    def update_vector(g, f, p, w, lr):
        g = g.to(torch.float32)
        f["v"].mul_(decay).add_((g * g).add_(eps), alpha=1 - decay)
        u = torch.rsqrt(f["v"] + eps).mul_(g)
        rms = torch.sqrt(torch.mean(u * u) + eps)
        _apply(u.div_(torch.clamp(rms / clip_threshold, min=1.0)), p, w, lr,
               weight_decay)

    @torch.no_grad()
    def update(grads, state, params, step, lr):
        for g, f, p, w in _leaves(grads, state, params):
            if p.ndim >= 2:
                update_matrices(g, f, p, w, lr)
            else:
                update_vector(g, f, p, w, lr)
        return params, state

    return Optimizer(init=_init, update=update, state_dims=_state_dims)


def adafactor_ref(decay=0.99, eps=1e-30, clip_threshold=1.0,
                  weight_decay=0.0) -> Optimizer:
    """Plain version of ``adafactor``: JAX's update line by line on each
    whole leaf (float32 temporaries the size of the leaf), written into the
    same state layout. Only the order of the RMS sum differs from the
    sliced update."""

    @torch.no_grad()
    def update(grads, state, params, step, lr):
        for g, f, p, w in _leaves(grads, state, params):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if p.ndim >= 2:
                vr = decay * f["vr"] + (1 - decay) * g2.mean(dim=-1)
                vc = decay * f["vc"] + (1 - decay) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                       min=eps))
                u = g * torch.rsqrt(denom + eps)
                f["vr"].copy_(vr)
                f["vc"].copy_(vc)
            else:
                v = decay * f["v"] + (1 - decay) * g2
                u = g * torch.rsqrt(v + eps)
                f["v"].copy_(v)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * w
            w.copy_(w - lr * u)
            if w is not p:
                p.copy_(w)
        return params, state

    return Optimizer(init=_init, update=update, state_dims=_state_dims)


__all__ = ["adafactor", "adafactor_ref"]
