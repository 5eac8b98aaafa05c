"""Core library: the paper's copy-detection algorithms in PyTorch.

Public API (the slice ported so far):
  CopyConfig, ClaimsDataset, DetectionResult    — data model
  DetectionEngine, EngineOptions                — THE detection entry point
                                                  (all nine modes of the JAX
                                                  engine, the tile scan over
                                                  a device mesh)
  Mesh, make_mesh, sharded_tile_scores,
  sharded_tile_scores_2d,
  distributed_pair_scores                       — the tile mesh (1-D, data×pod)
                                                  and the 2-D pair product
  pairwise_detect                               — exhaustive baseline (§II-B)
  bound_detect, hybrid_detect, BoundState       — BOUND/BOUND+/HYBRID (§IV)
  make_incremental_state, incremental_detect,
  IncrementalState                              — INCREMENTAL rounds (§V)
  sample_by_item, sample_by_cell, scale_sample  — sampling (§VI)
  BlockOrCache                                  — commit-maintained tile masks
  ChunkPrefetcher, PipelineStageError           — staged chunk pipeline
  build_index, engine_chunks, InvertedIndex     — inverted index (§III)
  bucketize, bucketize_engine, BucketedIndex    — legacy bucket views
  commit_rows, retract_rows, rollback_commit,
  compact_index, canonicalized                  — live corpus mutation
  index_detect_exact                            — INDEX (§III)
  bucketed_index_detect, pad_buckets            — bucketed INDEX (compat)
  rescore_pairs_exact                           — exact pair rescore
  CorpusStore, StoreSnapshot                    — chunked incidence store
  PackedBlock, pack_membership,
  unpack_membership, packed_count_matmul        — 1-bit membership
  ShardPlan, ShardedCorpusStore, shard_store    — row-range-sharded corpus
  make_shard_plan, rebalance_plan,
  merge_shard_partials, merge_owner_partials,
  OwnerPartial                                  — shard plans and merges
  ShardScanError, SpillCorruptionError,
  SealedShardError                              — shard-plane faults
  DetectionService, DetectRequest,
  DetectResponse, serve_batch, ResidentCorpus,
  ResultCache                                   — batched detection service
  ReplicaRouter, CircuitBreaker,
  ReplicaBroadcastError                         — replica / shard-owner fleet
  ServiceOverloaded, DeadlineExceeded,
  ServiceStopped                                — typed service refusals
  DurabilityOptions, CommitLog, CommitRecord,
  RetractRecord, RestoreInfo,
  NoValidSnapshotError, ReplayDivergenceError   — commit log and snapshots
  truth_finding, fusion_accuracy                — iterative fusion driver
  fagin_input                                   — NRA baseline (Table X)
"""
from repro_torch.core.bound import BoundState, bound_detect, hybrid_detect
from repro_torch.core.bucketed import (
    bucketed_index_detect,
    index_detect_exact,
    pad_buckets,
)
from repro_torch.core.distributed import (
    Mesh,
    distributed_pair_scores,
    make_mesh,
    sharded_tile_scores,
    sharded_tile_scores_2d,
)
from repro_torch.core.engine import DetectionEngine, EngineOptions
from repro_torch.core.fagin import fagin_input
from repro_torch.core.incremental import (
    IncrementalState,
    incremental_detect,
    make_incremental_state,
    rescore_pairs_exact,
)
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
from repro_torch.core.pipeline import ChunkPrefetcher, PipelineStageError
from repro_torch.core.sampling import sample_by_cell, sample_by_item, scale_sample
from repro_torch.core.scoring import pairwise_detect
from repro_torch.core.serving import (
    CircuitBreaker,
    DeadlineExceeded,
    DetectionService,
    DetectRequest,
    DetectResponse,
    ReplicaBroadcastError,
    ReplicaRouter,
    ResidentCorpus,
    ResultCache,
    ServiceOverloaded,
    ServiceStopped,
    serve_batch,
)
from repro_torch.core.shardplan import (
    OwnerPartial,
    SealedShardError,
    ShardedCorpusStore,
    ShardPlan,
    ShardScanError,
    SpillCorruptionError,
    make_shard_plan,
    merge_owner_partials,
    merge_shard_partials,
    rebalance_plan,
    shard_store,
)
from repro_torch.core.store import (
    CorpusStore,
    PackedBlock,
    StoreSnapshot,
    pack_membership,
    packed_count_matmul,
    unpack_membership,
)
from repro_torch.core.tilecache import BlockOrCache
from repro_torch.core.truthfind import fusion_accuracy, truth_finding
from repro_torch.core.types import (
    ClaimsDataset,
    CopyConfig,
    DetectionResult,
    claim_value_keys,
    pair_f_measure,
)
from repro_torch.core.wal import (
    CommitLog,
    CommitRecord,
    DurabilityOptions,
    NoValidSnapshotError,
    ReplayDivergenceError,
    RestoreInfo,
    RetractRecord,
)

__all__ = [
    "CopyConfig", "ClaimsDataset", "DetectionResult", "pair_f_measure",
    "claim_value_keys", "DetectionEngine", "EngineOptions", "Mesh",
    "make_mesh", "sharded_tile_scores", "sharded_tile_scores_2d",
    "distributed_pair_scores", "CorpusStore",
    "InvertedIndex", "pairwise_detect", "build_index", "engine_chunks",
    "index_detect_exact", "rescore_pairs_exact", "StoreSnapshot",
    "BucketedIndex", "bucketize", "bucketize_engine", "CommitInfo",
    "RetractInfo", "MutationDelta", "commit_rows", "retract_rows",
    "rollback_commit", "compact_index", "canonicalized",
    "bucketed_index_detect", "pad_buckets", "BoundState", "bound_detect",
    "hybrid_detect", "IncrementalState", "make_incremental_state",
    "incremental_detect", "sample_by_item", "sample_by_cell", "scale_sample",
    "BlockOrCache", "ChunkPrefetcher", "PipelineStageError", "PackedBlock",
    "pack_membership", "unpack_membership", "packed_count_matmul",
    "ShardPlan", "ShardedCorpusStore", "shard_store", "make_shard_plan",
    "rebalance_plan", "merge_shard_partials", "merge_owner_partials",
    "OwnerPartial", "ShardScanError", "SpillCorruptionError",
    "SealedShardError", "DetectRequest", "DetectResponse",
    "DetectionService", "ReplicaRouter", "ReplicaBroadcastError",
    "ResidentCorpus", "ResultCache", "serve_batch", "CircuitBreaker",
    "DeadlineExceeded", "ServiceOverloaded", "ServiceStopped",
"DurabilityOptions", "CommitLog", "CommitRecord",
    "RestoreInfo", "NoValidSnapshotError", "ReplayDivergenceError",
    "RetractRecord", "truth_finding", "fusion_accuracy", "fagin_input",
]
