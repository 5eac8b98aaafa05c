"""The LM stack of the port: the ``dense`` block kind (self attention through
the hand-written flash-attention kernel, a gated MLP) with KV-cached decode."""
from repro_torch.models.model import Model, greedy_decode, params_from_jax

__all__ = ["Model", "greedy_decode", "params_from_jax"]
