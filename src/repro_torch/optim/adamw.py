"""AdamW on parameter trees, with a float32 master copy for bf16 parameters.

The port of the JAX package's ``optim/adamw.py``: the same defaults and the
same update, in float32,
    m ← b1·m + (1 − b1)·g,   v ← b2·v + (1 − b2)·g²,
    u = (m / (1 − b1ᵗ)) / (√(v / (1 − b2ᵗ)) + eps) + wd·master,
    master ← master − lr·u,  param ← master in the parameter's dtype,
with t = step + 1. When any parameter is bf16 the state holds a float32
``master`` copy of every parameter. Unlike JAX, whose arrays are immutable,
``update`` writes the new moments, masters and parameters into the given
tensors in place (no second copy of the state exists during a step) and
returns the same trees. ``torch.optim.AdamW`` is not used: its state layout
and its master-copy handling differ. ``state_dims`` maps the parameters'
logical dims to the state's, for the sharding rules
(``runtime/sharding.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable        # params → state
    update: Callable      # (grads, state, params, step, lr) → (params, state)
    state_dims: Callable  # (param_dims, has_master) → the state's dims tree


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        state = {"m": tree_map(_zeros_f32, params),
                 "v": tree_map(_zeros_f32, params)}
        if any(p.dtype == torch.bfloat16 for p in tree_leaves(params)):
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    @torch.no_grad()
    def update(grads, state, params, step, lr):
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        masters = state.get("master", params)
        for g, m, v, p, w in zip(*(tree_leaves(x) for x in (
                grads, state["m"], state["v"], params, masters))):
            g = g.to(torch.float32)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
            u.add_(w, alpha=weight_decay)
            w.sub_(lr * u)
            if w is not p:
                p.copy_(w)
        return params, state

    return Optimizer(init=init, update=update, state_dims=_state_dims)


def _state_dims(param_dims, has_master=False):
    """The state's logical dims: each moment's leaf has its parameter's."""
    d = {"m": param_dims, "v": param_dims}
    if has_master:
        d["master"] = param_dims
    return d


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
