"""Config schema: model architectures and the layer plan.

The port's copy of the JAX package's ``configs/base.py``, cut to the fields
the ``dense`` path reads in serving and training: the same names, the same defaults and the same
``reduced()`` for them, so a test can build one configuration in both
packages and compare like with like. The fields of the other block kinds
(MoE, SSM, cross, hybrid windows), the MLP variants and the benchmark
shapes come with the slices whose code reads them (ROADMAP A14).

A model is a ``ModelConfig`` plus a *layer plan*: a list of
(block_kind, count) segments. Layers inside a segment are homogeneous and
their parameters are stacked over a leading layer dimension. The port runs
the ``dense`` kind (self-attention + SwiGLU MLP); a plan naming another
kind is refused by ``Model``.

``attention_impl`` selects the attention of the prefill/forward path:
``"kernel"`` (the default) goes through ``kernels.ops.flash_attention_fwd``,
which launches the hand-written CUDA kernel on a CUDA tensor and takes its
plain PyTorch version on a CPU tensor; ``"reference"`` is the plain
``kernels.ref.attention_ref``. (The JAX package names the kernel value
``pallas`` and defaults to ``reference``.)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

ATTENTION_IMPLS = ("kernel", "reference")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // n_heads
    # layer plan: tuple of (block_kind, count); () → (("dense", n_layers),)
    layer_plan: Tuple[Tuple[str, int], ...] = ()
    rope_theta: float = 10000.0
    # numerics / impl
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"
    attention_impl: str = "kernel"   # kernel | reference
    # training
    remat: bool = True
    optimizer: str = "adamw"         # adamw (adafactor waits, ROADMAP A14)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def plan(self) -> Tuple[Tuple[str, int], ...]:
        return self.layer_plan or (("dense", self.n_layers),)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, n_layers: int = 2, d_model: int = 64, d_ff: int = 128,
                vocab: int = 512) -> "ModelConfig":
        """A smoke-test-sized config of the same plan shape."""
        heads = max(2, min(4, self.n_heads))
        kv = max(1, min(heads, self.n_kv_heads))
        while heads % kv:
            kv -= 1
        plan = ()
        if self.layer_plan:
            # shrink the plan but keep its structure (≥1 of each segment kind)
            kinds = []
            for kind, _ in self.layer_plan:
                if not kinds or kinds[-1] != kind:
                    kinds.append(kind)
            plan = tuple((k, 1) for k in kinds[:n_layers])
        return self.replace(
            n_layers=len(plan) or n_layers,
            d_model=d_model, d_ff=d_ff, vocab_size=vocab,
            n_heads=heads, n_kv_heads=kv, head_dim=0, layer_plan=plan,
            dtype="float32", param_dtype="float32",
        )
