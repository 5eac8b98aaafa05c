"""The LM stack of the port: every block kind of the JAX package (``dense``,
``moe``, ``cross``, ``ssm``, ``hybrid_swa``, ``hybrid_full``; attention
through the hand-written flash-attention kernels) with KV-cached decode and
a differentiable loss."""
from repro_torch.models.model import (
    Model,
    greedy_decode,
    params_from_jax,
    train_state_from_jax,
)

__all__ = ["Model", "greedy_decode", "params_from_jax", "train_state_from_jax"]
