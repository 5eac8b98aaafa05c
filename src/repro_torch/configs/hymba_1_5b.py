"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per layer; SWA
(window 1024) everywhere except 3 full-attention layers (first/middle/last).
Sub-quadratic decode ⇒ long_500k runs. [arXiv:2411.13676; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, d_inner=3200, swa_window=1024,
    layer_plan=(("hybrid_full", 1), ("hybrid_swa", 14), ("hybrid_full", 1),
                ("hybrid_swa", 15), ("hybrid_full", 1)),
    supports_long_context=True,
)
