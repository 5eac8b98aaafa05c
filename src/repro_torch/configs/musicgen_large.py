"""musicgen-large [audio] — decoder-only over EnCodec tokens with text-
conditioning cross-attention every layer. The EnCodec/T5 frontends are STUBS:
input_specs() provides token ids + precomputed conditioning embeddings.
[arXiv:2306.05284; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    mlp_type="gelu",
    layer_plan=(("cross", 48),),
    cond_len=64, cond_dim=1024,
)
