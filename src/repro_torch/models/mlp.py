"""Feed-forward blocks: SwiGLU (llama/qwen/grok), GeGLU (gemma), GELU
(starcoder2, musicgen), with the JAX package's leaves (``wg/wu/wd`` for the
gated two, ``w1/w2`` for GELU).

The products stay ``torch.matmul``, as the JAX package leaves them to XLA.
Both GELUs are the tanh form: ``jax.nn.gelu`` defaults to
``approximate=True``, ``torch.nn.functional.gelu`` to the exact erf form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    D, F_ = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "wg": dense_init(gen, (D, F_)),
            "wu": dense_init(gen, (D, F_)),
            "wd": dense_init(gen, (F_, D)),
        }
    return {"w1": dense_init(gen, (D, F_)), "w2": dense_init(gen, (F_, D))}


def mlp_dims(cfg: ModelConfig):
    """Logical dims of ``init_mlp``'s leaves (``runtime/sharding.py``)."""
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"wg": ("d_model", "d_ff"), "wu": ("d_model", "d_ff"),
                "wd": ("d_ff", "d_model")}
    return {"w1": ("d_model", "d_ff"), "w2": ("d_ff", "d_model")}


def mlp_forward(p, x, cfg: ModelConfig):
    dt = x.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = x @ p["wg"].to(dt)
        u = x @ p["wu"].to(dt)
        act = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        return (act * u) @ p["wd"].to(dt)
    return F.gelu(x @ p["w1"].to(dt), approximate="tanh") @ p["w2"].to(dt)
