"""Architecture registry of the port: the architectures whose block kinds
the port runs (``dense``, ``ssm``, ``hybrid_swa``/``hybrid_full`` so far).
The JAX package's other architectures wait for their block kinds
(ROADMAP A.7).

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
from repro_torch.configs.hymba_1_5b import CONFIG as hymba_1_5b
from repro_torch.configs.llama3_2_1b import CONFIG as llama3_2_1b

REGISTRY = {c.name: c for c in [llama3_2_1b, falcon_mamba_7b, hymba_1_5b]}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port runs {ARCH_IDS} "
                       f"(the other block kinds wait, ROADMAP A.7)")
    return REGISTRY[name]


__all__ = ["get_config", "REGISTRY", "ARCH_IDS", "ATTENTION_IMPLS", "SHAPES",
           "ModelConfig", "ShapeConfig", "shape_applicable"]
