"""Config schema: model architectures, input shapes, and the layer plan.

The port's copy of the JAX package's ``configs/base.py``: the same fields,
names, defaults and ``reduced()``, so a test can build one configuration in
both packages and compare like with like.

A model is a ``ModelConfig`` plus a *layer plan*: a list of
(block_kind, count) segments. Layers inside a segment are homogeneous and
their parameters are stacked over a leading layer dimension. Block kinds:

  dense        — self-attn + MLP
  moe          — self-attn + mixture-of-experts FFN
  cross        — self-attn + cross-attn (conditioning) + MLP
  ssm          — Mamba1 mixer, no MLP
  hybrid_swa   — parallel attn (sliding window) + Mamba heads, then MLP
  hybrid_full  — parallel attn (full) + Mamba heads, then MLP

Every kind serves and trains.

``attention_impl`` selects the attention of the prefill/forward path:
``"kernel"`` (the default) goes through ``kernels.ops.flash_attention_fwd``,
which launches the hand-written CUDA kernel on a CUDA tensor and takes its
plain PyTorch version on a CPU tensor; ``"reference"`` is the plain
``kernels.ref.attention_ref``, and from 8192 query rows on the chunked
``kernels.ref.attention_chunked``, which ``"chunked"`` and
``"chunked_unroll"`` take at every length. (The JAX package names the
kernel value ``pallas`` and defaults to ``reference``.)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

ATTENTION_IMPLS = ("kernel", "reference", "chunked", "chunked_unroll")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // n_heads
    # layer plan: tuple of (block_kind, count); () → [(family's kind, n_layers)]
    layer_plan: Tuple[Tuple[str, int], ...] = ()
    # activations / details
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_routing: str = "local"       # local (row-local dispatch) | global
    # SSM (mamba1)
    ssm_state: int = 0
    d_inner: int = 0                 # 0 → 2 * d_model
    conv_kernel: int = 4
    dt_rank: int = 0                 # 0 → ceil(d_model / 16)
    ssm_chunk: int = 64              # chunked-scan granularity
    # attention windows (hybrid)
    swa_window: Optional[int] = None
    # conditioning (audio text-cond / vlm image layers)
    cond_len: int = 0
    cond_dim: int = 0
    # numerics / impl
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"
    attention_impl: str = "kernel"   # kernel | reference | chunked[_unroll]
    # training
    remat: bool = True
    optimizer: str = "adamw"         # adamw | adafactor
    # long-context capability (sub-quadratic decode)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def plan(self) -> Tuple[Tuple[str, int], ...]:
        if self.layer_plan:
            return self.layer_plan
        default = {"dense": "dense", "moe": "moe", "ssm": "ssm",
                   "hybrid": "hybrid_swa", "audio": "cross", "vlm": "dense"}
        return ((default[self.family], self.n_layers),)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, n_layers: int = 2, d_model: int = 64, d_ff: int = 128,
                vocab: int = 512, n_experts: Optional[int] = None) -> "ModelConfig":
        """A smoke-test-sized config of the same family/plan shape."""
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
        ne = self.n_experts and (n_experts if n_experts is not None
                                 else min(4, self.n_experts))
        return self.replace(
            n_layers=len(plan) or n_layers,
            d_model=d_model, d_ff=d_ff, vocab_size=vocab,
            n_heads=heads, n_kv_heads=kv, head_dim=0, layer_plan=plan,
            n_experts=ne or 0,
            d_inner=2 * d_model if self.family in ("ssm", "hybrid") else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            dt_rank=0, cond_len=min(self.cond_len, 8) if self.cond_len else 0,
            cond_dim=d_model if self.cond_dim else 0,
            swa_window=min(self.swa_window, 32) if self.swa_window else None,
            dtype="float32", param_dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md shape-skip notes)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k dense KV decode is "
                       "quadratic and unshardable at batch=1 — skipped per "
                       "DESIGN.md")
    return True, ""
