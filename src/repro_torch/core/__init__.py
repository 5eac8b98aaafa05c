"""Core library: the paper's copy-detection algorithms in PyTorch.

Public API (the slice ported so far):
  CopyConfig, ClaimsDataset, DetectionResult    — data model
  DetectionEngine, EngineOptions                — THE detection entry point
                                                  (modes pairwise, exact,
                                                  bucketed)
  pairwise_detect                               — exhaustive baseline (§II-B)
  build_index, engine_chunks, InvertedIndex     — inverted index (§III)
  bucketize, bucketize_engine, BucketedIndex    — legacy bucket views
  commit_rows, retract_rows, rollback_commit,
  compact_index, canonicalized                  — live corpus mutation
  index_detect_exact                            — INDEX (§III)
  bucketed_index_detect, pad_buckets            — bucketed INDEX (compat)
  rescore_pairs_exact                           — exact pair rescore
  CorpusStore, StoreSnapshot                    — chunked incidence store
"""
from repro_torch.core.bucketed import (
    bucketed_index_detect,
    index_detect_exact,
    pad_buckets,
)
from repro_torch.core.engine import DetectionEngine, EngineOptions
from repro_torch.core.incremental import rescore_pairs_exact
from repro_torch.core.index import (
    BucketedIndex,
    CommitInfo,
    InvertedIndex,
    MutationDelta,
    RetractInfo,
    bucketize,
    bucketize_engine,
    build_index,
    canonicalized,
    commit_rows,
    compact_index,
    engine_chunks,
    retract_rows,
    rollback_commit,
)
from repro_torch.core.scoring import pairwise_detect
from repro_torch.core.store import CorpusStore, StoreSnapshot
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
    "index_detect_exact", "rescore_pairs_exact", "StoreSnapshot",
    "BucketedIndex", "bucketize", "bucketize_engine", "CommitInfo",
    "RetractInfo", "MutationDelta", "commit_rows", "retract_rows",
    "rollback_commit", "compact_index", "canonicalized",
    "bucketed_index_detect", "pad_buckets",
]
