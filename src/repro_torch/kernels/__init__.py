"""Hand-written Hopper kernels (``csrc/``, built at first use by ``_build``)
with their plain PyTorch versions (``ref``); ``ops`` holds the wrappers that
dispatch by the device of their tensors."""
from repro_torch.kernels.ops import (
    FlashAttention,
    copyscore,
    copyscore_store,
    copyscore_tile,
    copyscore_tile_fused,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    pad_for_copyscore,
    pair_scores,
    tile_scores,
)

__all__ = ["FlashAttention", "copyscore", "copyscore_store", "copyscore_tile",
           "copyscore_tile_fused", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_fwd", "pad_for_copyscore", "pair_scores",
           "tile_scores"]
