"""Optimizers and schedules of the port: AdamW (``adafactor`` waits,
ROADMAP A.7), the warmup-cosine schedule and global-norm clipping."""
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.schedule import clip_by_global_norm, warmup_cosine

OPTIMIZERS = {"adamw": adamw}

__all__ = ["OPTIMIZERS", "Optimizer", "adamw", "clip_by_global_norm",
           "warmup_cosine"]
