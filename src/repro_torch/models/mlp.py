"""Feed-forward block: SwiGLU (the llama family's).

The products stay ``torch.matmul``, as the JAX package leaves them to XLA.
The JAX package's GeGLU and GELU blocks come with the architectures that
use them (ROADMAP A.7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "wg": dense_init(gen, (D, F_)),
        "wu": dense_init(gen, (D, F_)),
        "wd": dense_init(gen, (F_, D)),
    }


def mlp_forward(p, x):
    dt = x.dtype
    return (F.silu(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))) @ p["wd"].to(dt)
