from repro_torch.data.claims import (
    motivating_example,
    motivating_value_probs,
    synthetic_claims,
)

__all__ = ["motivating_example", "motivating_value_probs", "synthetic_claims"]
