"""falcon-mamba-7b [ssm] — attention-free Mamba-1; O(1)-state decode makes
long_500k runnable. [arXiv:2410.05355; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=65024,
    ssm_state=16, d_inner=8192, conv_kernel=4,
    supports_long_context=True,
)
