"""llama-3.2-vision-11b [vlm] — text decoder with cross-attention image
layers every 5th layer. The vision tower is a STUB: input_specs() provides
precomputed patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    mlp_type="swiglu", rope_theta=500000.0,
    layer_plan=(("dense", 4), ("cross", 1)) * 8,
    cond_len=1024, cond_dim=4096,
)
