"""Optimizers and schedules of the port: AdamW, the warmup-cosine schedule
and global-norm clipping. ``adafactor`` waits (ROADMAP A.7): it is what
would train falcon-mamba-7b at full depth on one card, where AdamW's
float32 parameters, gradients and two moments of 7.27 B parameters (16
bytes a parameter, 116 GB) exceed 80 GB; its port needs an update that
never makes a whole-leaf float32 temporary of a stacked leaf."""
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.schedule import clip_by_global_norm, warmup_cosine

OPTIMIZERS = {"adamw": adamw}


def get_optimizer(name: str):
    """The optimizer factory of ``OPTIMIZERS`` named ``name``; a name of the
    JAX package's that the port lacks (``adafactor``, grok-1-314b's) raises
    ``NotImplementedError``."""
    if name not in OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported (ROADMAP A.7: Adafactor comes "
            f"with a later slice); the port has {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name]


__all__ = ["OPTIMIZERS", "Optimizer", "adamw", "clip_by_global_norm",
           "get_optimizer", "warmup_cosine"]
