"""Computation-count accounting.

The paper measures efficiency with two metrics: wall time and the number of
"computations" (per-pair per-value score evaluations; examples in §III-V:
PAIRWISE on the motivating example conducts 366 computations, INDEX 154,
BOUND 116). Wall time on one machine is not comparable with the paper's
Java numbers, so every detection algorithm in ``repro_torch.core``
additionally reports these hardware-independent counts, computed with the
paper's own accounting rules:

* examining a shared value for a pair costs 2 computations (one for C→,
  one for C←);
* the per-pair different-value adjustment (step 3 of INDEX) costs 2;
* evaluating a min/max bound for a pair costs 1 per bound (Ex. 4.2 counts
  4 + 1 = 5 for two bound evaluations plus ... consistent with §IV examples);
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ComputeCounter:
    pairs_considered: int = 0
    shared_values_examined: int = 0
    score_computations: int = 0
    bound_computations: int = 0
    index_entries: int = 0

    @property
    def total(self) -> int:
        return self.score_computations + self.bound_computations

    def merge(self, other: "ComputeCounter") -> "ComputeCounter":
        return ComputeCounter(
            pairs_considered=self.pairs_considered + other.pairs_considered,
            shared_values_examined=self.shared_values_examined + other.shared_values_examined,
            score_computations=self.score_computations + other.score_computations,
            bound_computations=self.bound_computations + other.bound_computations,
            index_entries=max(self.index_entries, other.index_entries),
        )

    def as_dict(self) -> dict:
        return {
            "pairs_considered": self.pairs_considered,
            "shared_values_examined": self.shared_values_examined,
            "score_computations": self.score_computations,
            "bound_computations": self.bound_computations,
            "total_computations": self.total,
        }
