"""llama3.2-1b [dense] — hf:meta-llama/Llama-3.2-1B (unverified tier)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    rope_theta=500000.0,
)
