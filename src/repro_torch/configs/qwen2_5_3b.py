"""qwen2.5-3b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5; hf tier]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab_size=151936,
    mlp_type="swiglu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1000000.0,
)
