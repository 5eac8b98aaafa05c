"""Optimizers and schedules of the port: AdamW, Adafactor (the factored
second moment that trains falcon-mamba-7b at full depth on one card and
that grok-1-314b's config names), the warmup-cosine schedule and
global-norm clipping."""
from repro_torch.optim.adafactor import adafactor, adafactor_ref
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.schedule import clip_by_global_norm, warmup_cosine

OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor}


def get_optimizer(name: str):
    """The optimizer factory of ``OPTIMIZERS`` named ``name``; an unknown
    name raises ``KeyError``."""
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; the port has "
                       f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name]


__all__ = ["OPTIMIZERS", "Optimizer", "adafactor", "adafactor_ref", "adamw",
           "clip_by_global_norm", "get_optimizer", "warmup_cosine"]
