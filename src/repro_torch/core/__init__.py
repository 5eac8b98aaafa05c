"""Core library: the paper's copy-detection algorithms in PyTorch.

Public API (the slice ported so far):
  CopyConfig, ClaimsDataset, DetectionResult    — data model
  DetectionEngine, EngineOptions                — THE detection entry point
                                                  (modes pairwise, exact,
                                                  bucketed)
  pairwise_detect                               — exhaustive baseline (§II-B)
  build_index, engine_chunks, InvertedIndex     — inverted index (§III)
  index_detect_exact                            — INDEX (§III)
  rescore_pairs_exact                           — exact pair rescore
  CorpusStore                                   — chunked incidence store
"""
from repro_torch.core.bucketed import index_detect_exact
from repro_torch.core.engine import DetectionEngine, EngineOptions
from repro_torch.core.incremental import rescore_pairs_exact
from repro_torch.core.index import InvertedIndex, build_index, engine_chunks
from repro_torch.core.scoring import pairwise_detect
from repro_torch.core.store import CorpusStore
from repro_torch.core.types import (
    ClaimsDataset,
    CopyConfig,
    DetectionResult,
    claim_value_keys,
    pair_f_measure,
)

__all__ = [
    "CopyConfig", "ClaimsDataset", "DetectionResult", "pair_f_measure",
    "claim_value_keys", "DetectionEngine", "EngineOptions", "CorpusStore",
    "InvertedIndex", "pairwise_detect", "build_index", "engine_chunks",
    "index_detect_exact", "rescore_pairs_exact",
]
