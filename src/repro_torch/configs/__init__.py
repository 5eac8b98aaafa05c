"""Architecture registry of the port: the architectures whose block kinds
the port runs (``dense`` so far). The JAX package's other architectures
wait for their block kinds (ROADMAP A14).

``get_config(arch_id)`` returns the full-size ModelConfig;
``get_config(arch_id).reduced()`` is the smoke-test size.
"""
from repro_torch.configs.base import ATTENTION_IMPLS, ModelConfig
from repro_torch.configs.llama3_2_1b import CONFIG as llama3_2_1b

REGISTRY = {c.name: c for c in [llama3_2_1b]}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port runs {ARCH_IDS} "
                       f"(the other block kinds wait, ROADMAP A14)")
    return REGISTRY[name]


__all__ = ["get_config", "REGISTRY", "ARCH_IDS", "ATTENTION_IMPLS",
           "ModelConfig"]
