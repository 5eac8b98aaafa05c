"""Hand-written Hopper kernels (``csrc/``, built at first use by ``_build``)
with their plain PyTorch versions (``ref``); ``ops`` holds the wrappers that
dispatch by the device of their tensors."""
from repro_torch.kernels.ops import copyscore_tile_fused, tile_scores

__all__ = ["copyscore_tile_fused", "tile_scores"]
