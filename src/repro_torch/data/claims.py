"""Claims datasets: the paper's motivating example (Table I) and the
synthetic generator shaped like the paper's experimental datasets (Table V).

The generator is numpy and seeded, so the same ``SyntheticSpec`` gives the
same arrays here and in the JAX package: the port's tests hand one world to
both. The synthetic generator plants a ground-truth copying structure so
that copy-detection precision/recall can be measured against a known
reference, in two regimes:

* *Book-like*  — many sources, low coverage (85% of sources cover ≤ 1% of
  items), long-tail; copying within small cliques.
* *Stock-like* — few sources, high coverage (80% cover ≥ 50%).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.types import ClaimsDataset

# ---------------------------------------------------------------------------
# Motivating example — Table I
# ---------------------------------------------------------------------------

_ITEMS = ["NJ", "AZ", "NY", "FL", "TX"]
_TABLE_I = {
    #        NJ          AZ         NY         FL         TX         acc
    "S0": (("Trenton", "Phoenix", "Albany", None, "Austin"), 0.99),
    "S1": (("Trenton", "Phoenix", "Albany", "Orlando", "Austin"), 0.99),
    "S2": (("Atlantic", "Phoenix", "NewYork", "Miami", "Houston"), 0.2),
    "S3": (("Atlantic", "Phoenix", "NewYork", "Miami", "Arlington"), 0.2),
    "S4": (("Atlantic", "Phoenix", "NewYork", "Orlando", "Houston"), 0.4),
    "S5": (("Union", "Tempe", "Albany", "Orlando", "Austin"), 0.6),
    "S6": ((None, "Tempe", "Buffalo", "PalmBay", "Dallas"), 0.01),
    "S7": (("Trenton", None, "Buffalo", "PalmBay", "Dallas"), 0.25),
    "S8": (("Trenton", "Tucson", "Buffalo", "PalmBay", "Dallas"), 0.2),
    "S9": (("Trenton", None, None, "Orlando", "Austin"), 0.99),
}

# Converged value-truth probabilities, Table III (plus singletons).
_TABLE_III_P = {
    ("AZ", "Tempe"): 0.02, ("NJ", "Atlantic"): 0.01, ("TX", "Houston"): 0.02,
    ("NY", "NewYork"): 0.02, ("TX", "Dallas"): 0.02, ("NY", "Buffalo"): 0.04,
    ("FL", "PalmBay"): 0.05, ("FL", "Miami"): 0.03, ("AZ", "Phoenix"): 0.95,
    ("NJ", "Trenton"): 0.97, ("FL", "Orlando"): 0.92, ("NY", "Albany"): 0.94,
    ("TX", "Austin"): 0.96,
    # singletons (not indexed; only used for claim-probability completeness)
    ("NJ", "Union"): 0.02, ("AZ", "Tucson"): 0.02, ("TX", "Arlington"): 0.02,
}


def motivating_example() -> ClaimsDataset:
    """Table I as a ClaimsDataset. Value ids are per-item, assigned in first-
    appearance order over S0..S9 so tests can name them via value_names."""
    sources = list(_TABLE_I.keys())
    vmaps: list[dict] = [dict() for _ in _ITEMS]
    values = -np.ones((len(sources), len(_ITEMS)), dtype=np.int32)
    value_names = {}
    for si, s in enumerate(sources):
        row, _ = _TABLE_I[s]
        for d, v in enumerate(row):
            if v is None:
                continue
            if v not in vmaps[d]:
                vmaps[d][v] = len(vmaps[d])
                value_names[(d, vmaps[d][v])] = f"{_ITEMS[d]}.{v}"
            values[si, d] = vmaps[d][v]
    acc = np.array([_TABLE_I[s][1] for s in sources], dtype=np.float32)
    return ClaimsDataset(values=values, accuracy=acc, item_names=_ITEMS,
                         source_names=sources, value_names=value_names)


def motivating_value_probs(ds: ClaimsDataset) -> np.ndarray:
    """The converged P(D.v) of Table III expanded to a (S, D) claim matrix."""
    p = np.zeros(ds.values.shape, dtype=np.float32)
    inv = {v: k for k, v in ds.value_names.items()}
    for (item, vname), prob in _TABLE_III_P.items():
        d = _ITEMS.index(item)
        key = inv.get(f"{item}.{vname}")
        if key is None:
            continue
        _, vid = key
        p[ds.values[:, d] == vid, d] = prob
    return p


GROUND_TRUTH_COPIES = {(2, 3), (2, 4), (3, 4), (6, 7), (6, 8), (7, 8)}
"""The paper: "There is copying between S2–S4 and between S6–S8"."""


# ---------------------------------------------------------------------------
# Synthetic generator (Table V regimes)
# ---------------------------------------------------------------------------

@dataclass
class SyntheticSpec:
    n_sources: int = 200
    n_items: int = 2000
    n_false: int = 50                  # domain size of false values per item
    coverage: str = "book"             # "book" (long-tail) | "stock" (dense)
    n_cliques: int = 10                # copying cliques planted
    clique_size: int = 3
    copy_selectivity: float = 0.8      # fraction of the original's items copied
    clique_items: int | None = None    # if set, clique sources provide exactly
                                       # this many items (the paper's Book-CS
                                       # regime: copiers with tiny coverage)
    acc_low: float = 0.35
    acc_high: float = 0.95
    seed: int = 0


@dataclass
class SyntheticClaims:
    dataset: ClaimsDataset
    true_values: np.ndarray            # (D,) int32 — value id 0 is always truth
    copies: set = field(default_factory=set)      # unordered pairs (i, j), i<j
    copy_edges: list = field(default_factory=list)  # (copier, original)


def synthetic_claims(spec: SyntheticSpec) -> SyntheticClaims:
    """Generate sources with planted accuracies, coverage profile, and
    copying cliques (each clique: one original + members that copy a random
    `copy_selectivity` fraction of its claims and independently fill the rest).

    Raises ``ValueError`` when the clique plan needs more distinct sources
    than exist — clique members are drawn without replacement, so
    ``n_cliques · clique_size > n_sources`` would spin the rejection loop
    below forever instead of ever returning.
    """
    needed = spec.n_cliques * spec.clique_size
    if needed > spec.n_sources:
        raise ValueError(
            f"spec needs {spec.n_cliques} cliques × {spec.clique_size} "
            f"distinct sources = {needed}, but n_sources={spec.n_sources}; "
            f"shrink the cliques or add sources")
    rng = np.random.default_rng(spec.seed)
    S, D = spec.n_sources, spec.n_items
    true_vals = np.zeros(D, dtype=np.int32)    # truth coded as value 0
    acc = rng.uniform(spec.acc_low, spec.acc_high, size=S).astype(np.float32)

    if spec.coverage == "book":
        # long-tail: most sources cover few items
        cov = np.clip(rng.pareto(1.2, size=S) * 0.01 + 0.005, 0.003, 0.9)
    else:
        cov = rng.uniform(0.5, 1.0, size=S)

    values = -np.ones((S, D), dtype=np.int32)
    for s in range(S):
        m = rng.random(D) < cov[s]
        idx = np.nonzero(m)[0]
        correct = rng.random(idx.size) < acc[s]
        v = np.where(correct, 0, rng.integers(1, spec.n_false + 1, size=idx.size))
        values[s, idx] = v

    # plant copying cliques: members overwrite a fraction of the original's claims
    copies: set = set()
    copy_edges: list = []
    originals = rng.choice(S, size=spec.n_cliques, replace=False)
    used = set(originals.tolist())
    for o in originals:
        if spec.clique_items is not None:
            # paper's Book-CS regime: clique sources have tiny coverage
            k = spec.clique_items
            values[o, :] = -1
            idx = rng.choice(D, size=k, replace=False)
            correct = rng.random(k) < acc[o]
            values[o, idx] = np.where(correct, 0, rng.integers(1, spec.n_false + 1, size=k))
        elif (values[o] >= 0).sum() < 20:
            # make sure the original has enough claims to copy from
            idx = rng.choice(D, size=20, replace=False)
            correct = rng.random(20) < acc[o]
            values[o, idx] = np.where(correct, 0, rng.integers(1, spec.n_false + 1, size=20))
        members = []
        for _ in range(spec.clique_size - 1):
            c = int(rng.integers(0, S))
            while c in used:
                c = int(rng.integers(0, S))
            used.add(c)
            members.append(c)
        o_idx = np.nonzero(values[o] >= 0)[0]
        for c in members:
            if spec.clique_items is not None:
                values[c, :] = -1          # copier's world is the original's
            take = o_idx[rng.random(o_idx.size) < spec.copy_selectivity]
            values[c, take] = values[o, take]
            copy_edges.append((c, int(o)))
            copies.add((min(c, int(o)), max(c, int(o))))
        # co-copiers share most of the original ⇒ also detected as dependent
        for a in members:
            for b in members:
                if a < b:
                    copies.add((a, b))

    ds = ClaimsDataset(values=values, accuracy=acc)
    return SyntheticClaims(dataset=ds, true_values=true_vals, copies=copies,
                           copy_edges=copy_edges)


def oracle_claim_probs(sc: SyntheticClaims) -> np.ndarray:
    """Claim-probability matrix assuming oracle knowledge of the truth:
    value 0 (truth) w.p. .95, others .02 — used for single-round passes."""
    values = sc.dataset.values
    return np.where(values == 0, 0.95,
                    np.where(values > 0, 0.02, 0.0)).astype(np.float32)


__all__ = ["GROUND_TRUTH_COPIES", "SyntheticClaims", "SyntheticSpec",
           "motivating_example", "motivating_value_probs",
           "oracle_claim_probs", "synthetic_claims"]
