"""INCREMENTAL detection across fusion rounds (§V) — this slice carries only
the exact pair rescore the tiled engine's finalize needs; the round
bookkeeping is not carried yet (ROADMAP A6/A8)."""
from __future__ import annotations

import torch

from repro_torch.core.scoring import pair_scores_subset
from repro_torch.core.types import CopyConfig


def rescore_pairs_exact(
    vals: torch.Tensor,
    p: torch.Tensor,
    acc: torch.Tensor,
    cfg: CopyConfig,
    pi: torch.Tensor,
    pj: torch.Tensor,
    c_fwd: torch.Tensor,
) -> int:
    """Batched exact rescore of an explicit flip-candidate pair list.

    Args:
      vals, p, acc: the *full* dataset's (S, D) int32 values, (S, D) float32
        per-claim truth probabilities and (S,) float32 accuracies, on the
        device of ``c_fwd``.
      pi, pj: (P,) int64 tensors of source indices — the unordered pairs to
        rescore (each listed once; both orientations are written).
      c_fwd: (S, S) float32 C→ matrix, updated in place at [pi, pj] and
        [pj, pi] with exact Eq. 2–8 scores over all shared items.

    Returns the number of pairs rescored (0 for an empty list).
    """
    if len(pi) == 0:
        return 0
    c_fwd[pi, pj] = pair_scores_subset(vals, p, acc, cfg, pi, pj)
    c_fwd[pj, pi] = pair_scores_subset(vals, p, acc, cfg, pj, pi)
    return len(pi)


__all__ = ["rescore_pairs_exact"]
