from repro_torch.data.claims import (
    motivating_example,
    motivating_value_probs,
    synthetic_claims,
)
from repro_torch.data.tokens import (
    Prefetcher,
    TokenCorpus,
    batches,
    synthetic_corpus,
)

__all__ = ["Prefetcher", "TokenCorpus", "batches", "motivating_example",
           "motivating_value_probs", "synthetic_claims", "synthetic_corpus"]
