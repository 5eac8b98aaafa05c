"""Data model for structured-source copy detection.

A *claims dataset* is the paper's (S, D) world: a set of sources each
providing at most one value per data item. Values are integer-coded per
item (two sources share a value on item d iff their codes are equal and
nonnegative). ``-1`` encodes a missing value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class CopyConfig:
    """Model hyper-parameters of the Bayesian copy model (§II-A).

    alpha: a-priori probability of one source copying another (0 < α < .5).
    s:     copy selectivity — probability a copier copies a particular item.
    n:     number of uniformly-distributed false values per item.
    c:     discount applied to a copier's vote during truth finding.
    """

    alpha: float = 0.1
    s: float = 0.8
    n: float = 50.0
    c: float = 0.8

    @property
    def beta(self) -> float:
        """β = 1 − 2α: a-priori probability the pair is independent (§II-A)."""
        return 1.0 - 2.0 * self.alpha

    @property
    def theta_ind(self) -> float:
        """No-copying threshold θ_ind = ln(β/2α) (§IV-A)."""
        return float(np.log(self.beta / (2.0 * self.alpha)))

    @property
    def theta_cp(self) -> float:
        """Copying threshold θ_cp = ln(β/α) (§IV-A)."""
        return float(np.log(self.beta / self.alpha))

    @property
    def ln_1ms(self) -> float:
        """Different-value contribution ln(1−s) (Eq. 8)."""
        return float(np.log(1.0 - self.s))

    def replace(self, **kw) -> "CopyConfig":
        """A copy of this config with the given fields replaced."""
        return dataclasses.replace(self, **kw)


@dataclass
class ClaimsDataset:
    """values[s, d] = integer value id provided by source s on item d (−1 = missing)."""

    values: np.ndarray              # (S, D) int32
    accuracy: np.ndarray            # (S,)  float32 — current accuracy estimates A(S)
    item_names: Optional[Sequence[str]] = None
    source_names: Optional[Sequence[str]] = None
    value_names: Optional[dict] = None   # {(item, value_id): str}

    def __post_init__(self):
        self.values = np.asarray(self.values, dtype=np.int32)
        self.accuracy = np.asarray(self.accuracy, dtype=np.float32)
        assert self.values.ndim == 2
        assert self.accuracy.shape == (self.values.shape[0],)

    @property
    def n_sources(self) -> int:
        """|S| — number of sources (rows)."""
        return self.values.shape[0]

    @property
    def n_items(self) -> int:
        """|D| — number of data items (columns)."""
        return self.values.shape[1]

    @property
    def provided_mask(self) -> np.ndarray:
        """(S, D) bool — True where the source provides a value."""
        return self.values >= 0

    @property
    def items_per_source(self) -> np.ndarray:
        """|D̄(S)| per source."""
        return self.provided_mask.sum(axis=1).astype(np.int32)

    def claim_probability(self, value_probs: dict) -> np.ndarray:
        """Expand a {(d, v): P(D.v)} map to a (S, D) matrix of per-claim truth
        probabilities (probability the value *this source provided* is true)."""
        p = np.zeros(self.values.shape, dtype=np.float32)
        for s in range(self.n_sources):
            for d in range(self.n_items):
                v = self.values[s, d]
                if v >= 0:
                    p[s, d] = value_probs[(d, int(v))]
        return p

    def row_view(self, n_rows: int) -> "ClaimsDataset":
        """A ZERO-COPY view of the first ``n_rows`` sources.

        The returned dataset shares this dataset's buffers — the serving
        layer's resident corpus (``core/serving.ResidentCorpus``) uses this
        to expose corpus + staged query rows without concatenating a new
        dataset per batch (DESIGN.md §6). Mutating either aliases the other.
        """
        return ClaimsDataset(
            values=self.values[:n_rows],
            accuracy=self.accuracy[:n_rows],
            item_names=self.item_names,
        )

    def subset_items(self, item_idx: np.ndarray) -> "ClaimsDataset":
        """The dataset restricted to the given item columns (sources kept).

        This is the sampling projection of §VI: detection on the subset is
        the cheap candidate-discovery pass of ``sampled``/``sample_verify``
        (DESIGN.md §4)."""
        return ClaimsDataset(
            values=self.values[:, item_idx],
            accuracy=self.accuracy.copy(),
            item_names=[self.item_names[i] for i in item_idx] if self.item_names else None,
            source_names=self.source_names,
        )


@dataclass
class DetectionResult:
    """Output of a copy-detection algorithm for every ordered pair."""

    c_fwd: np.ndarray            # (S, S) C→ : [i, j] = evidence that i copies from j
    pr_independent: np.ndarray   # (S, S) Pr(Si ⊥ Sj | Φ), symmetric
    copying: np.ndarray          # (S, S) bool, symmetric: Pr⊥ ≤ .5
    counter: object = None       # ComputeCounter
    wall_time_s: float = 0.0

    @property
    def c_bwd(self) -> np.ndarray:
        """C← — evidence that j copies from i (the transpose, §II symmetry)."""
        return self.c_fwd.T

    def copying_pairs(self) -> set:
        """The detected unordered copying pairs as a set of (i, j), i < j."""
        s = set()
        idx = np.argwhere(self.copying)
        for i, j in idx:
            if i < j:
                s.add((int(i), int(j)))
        return s


#: Composite-key base for (item, value) claim keys: key = item·KEY_BASE + value.
#: One fixed base (rather than a per-dataset max) keeps keys comparable across
#: epochs — the result cache intersects key sets from different commits
#: (DESIGN.md §7), so the coding must not shift as new value ids appear.
CLAIM_KEY_BASE = np.int64(1) << 32


def claim_value_keys(values: np.ndarray) -> np.ndarray:
    """Composite int64 keys of the provided (item, value) claims in ``values``.

    ``values`` is any ``(…, D)`` integer value matrix in the corpus coding
    (−1 = missing). Returns the sorted unique keys ``d·CLAIM_KEY_BASE + v``
    of all provided claims — the currency of ``commit_rows``'s delta
    detection and of the serving cache's invalidation test: two sources can
    share a value iff their key sets intersect.
    """
    values = np.asarray(values)
    d = np.broadcast_to(
        np.arange(values.shape[-1], dtype=np.int64), values.shape)
    keys = d * CLAIM_KEY_BASE + values
    return np.unique(keys[values >= 0])


def pair_f_measure(pred: set, truth: set) -> tuple:
    """Precision/recall/F of detected copying pairs vs a reference set."""
    if not pred and not truth:
        return 1.0, 1.0, 1.0
    tp = len(pred & truth)
    prec = tp / len(pred) if pred else 0.0
    rec = tp / len(truth) if truth else 0.0
    f = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
    return prec, rec, f
