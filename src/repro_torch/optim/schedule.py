"""LR schedules and gradient clipping, in float32 as the JAX package's
``optim/schedule.py`` computes them."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """lr(step) → a float32 scalar tensor on ``step``'s device: linear
    warmup to ``peak_lr``, then a cosine decay to ``floor · peak_lr`` at
    ``total_steps``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale a list of gradients so that their global norm is at most
    ``max_norm``; returns (grads, norm before clipping). The norm is taken
    in float32 over every leaf, as in the JAX package. Unlike JAX, the
    gradients are scaled in place (they are the step's own temporaries)
    and the same list is returned."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(scale)        # a bf16 g is scaled in float32 and rounded once
    return grads, norm
