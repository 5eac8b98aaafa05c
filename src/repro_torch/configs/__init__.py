"""Architecture registry of the port: every architecture of the JAX
package, in its order (the flash-attention kernels take gemma-2b's
head_dim of 256 beside 64 and 128).

``get_config(arch_id)`` returns the full-size ModelConfig;
``get_config(arch_id).reduced()`` is the smoke-test size.
"""
from repro_torch.configs.base import (
    ATTENTION_IMPLS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    shape_applicable,
)
from repro_torch.configs.falcon_mamba_7b import CONFIG as falcon_mamba_7b
from repro_torch.configs.gemma_2b import CONFIG as gemma_2b
from repro_torch.configs.grok1_314b import CONFIG as grok1_314b
from repro_torch.configs.hymba_1_5b import CONFIG as hymba_1_5b
from repro_torch.configs.llama3_2_1b import CONFIG as llama3_2_1b
from repro_torch.configs.llama3_2_vision_11b import CONFIG as llama3_2_vision_11b
from repro_torch.configs.musicgen_large import CONFIG as musicgen_large
from repro_torch.configs.phi3_5_moe import CONFIG as phi3_5_moe
from repro_torch.configs.qwen2_5_3b import CONFIG as qwen2_5_3b
from repro_torch.configs.starcoder2_15b import CONFIG as starcoder2_15b

REGISTRY = {
    c.name: c for c in [
        llama3_2_1b, qwen2_5_3b, gemma_2b, starcoder2_15b, phi3_5_moe,
        grok1_314b, falcon_mamba_7b, musicgen_large, hymba_1_5b,
        llama3_2_vision_11b,
    ]
}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return REGISTRY[name]


__all__ = ["get_config", "REGISTRY", "ARCH_IDS", "ATTENTION_IMPLS", "SHAPES",
           "ModelConfig", "ShapeConfig", "shape_applicable"]
