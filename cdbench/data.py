"""Frozen copy of the synthetic claims generator the benchmark's traffic uses.

The numpy draws are those of ``repro_torch.data.claims`` as of the
benchmark's first version (``SyntheticSpec``, ``synthetic_claims``,
``book_full_spec``, ``oracle_claim_probs``), kept here so that a later
change to the program cannot change the yardstick.
``tests/test_cdbench_data.py`` holds them equal, draw for draw, to the
program's at a small size. Everything returns plain numpy.

``new_sources`` draws sources that arrive after the world was made, as the
generator draws a source of the world; ``truth_table`` gives the truth
probability of every (item, value), from the oracle or from one
accuracy-weighted vote over the world's claims.

On top of the copies, ``relabel`` turns one generated world into the
world a ``--seed`` asks for: the same claims with sources, items and the
false values of each item renumbered by a permutation drawn from the seed.
Every seed so gets the same sizes and the same work, in another order.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SyntheticSpec:
    n_sources: int = 200
    n_items: int = 2000
    n_false: int = 50                  # domain size of false values per item
    coverage: str = "book"             # "book" (long-tail) | "stock" (dense)
    n_cliques: int = 10                # copying cliques planted
    clique_size: int = 3
    copy_selectivity: float = 0.8      # fraction of the original's items copied
    clique_items: int | None = None    # clique sources provide exactly this
                                       # many items (the Book-CS regime)
    acc_low: float = 0.35
    acc_high: float = 0.95
    seed: int = 0


@dataclass
class World:
    """A generated claims world: ``values`` (S, D) int32 with -1 for a
    missing claim and 0 for the true value, ``accuracy`` (S,) float32."""

    values: np.ndarray
    accuracy: np.ndarray
    copies: set = field(default_factory=set)       # unordered planted pairs
    copy_edges: list = field(default_factory=list)  # (copier, original)


def _coverage(rng, coverage: str, n: int) -> np.ndarray:
    """The share of items each of ``n`` sources provides."""
    if coverage == "book":
        return np.clip(rng.pareto(1.2, size=n) * 0.01 + 0.005, 0.003, 0.9)
    return rng.uniform(0.5, 1.0, size=n)


def _own_claims(rng, row: np.ndarray, cov: float, acc: float,
                n_false: int) -> None:
    """Fill one source's row: each item provided with probability ``cov``,
    its value true (0) with probability ``acc``, else a false one."""
    idx = np.nonzero(rng.random(row.size) < cov)[0]
    correct = rng.random(idx.size) < acc
    row[idx] = np.where(correct, 0, rng.integers(1, n_false + 1, size=idx.size))


def synthetic_claims(spec: SyntheticSpec) -> World:
    """Sources with planted accuracies, a coverage profile and copying
    cliques (one original and members that copy ``copy_selectivity`` of
    its claims)."""
    needed = spec.n_cliques * spec.clique_size
    if needed > spec.n_sources:
        raise ValueError(f"spec needs {needed} distinct clique sources, "
                         f"n_sources={spec.n_sources}")
    rng = np.random.default_rng(spec.seed)
    S, D = spec.n_sources, spec.n_items
    acc = rng.uniform(spec.acc_low, spec.acc_high, size=S).astype(np.float32)
    cov = _coverage(rng, spec.coverage, S)

    values = -np.ones((S, D), dtype=np.int32)
    for s in range(S):
        _own_claims(rng, values[s], cov[s], acc[s], spec.n_false)

    copies: set = set()
    copy_edges: list = []
    originals = rng.choice(S, size=spec.n_cliques, replace=False)
    used = set(originals.tolist())
    for o in originals:
        if spec.clique_items is not None:
            k = spec.clique_items
            values[o, :] = -1
            idx = rng.choice(D, size=k, replace=False)
            correct = rng.random(k) < acc[o]
            values[o, idx] = np.where(correct, 0, rng.integers(1, spec.n_false + 1, size=k))
        elif (values[o] >= 0).sum() < 20:
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
                values[c, :] = -1
            take = o_idx[rng.random(o_idx.size) < spec.copy_selectivity]
            values[c, take] = values[o, take]
            copy_edges.append((c, int(o)))
            copies.add((min(c, int(o)), max(c, int(o))))
        for a in members:
            for b in members:
                if a < b:
                    copies.add((a, b))
    return World(values=values, accuracy=acc, copies=copies,
                 copy_edges=copy_edges)


def book_full_spec(seed: int = 0) -> SyntheticSpec:
    """Table V's Book-full scale: 3,182 sources × 20,000 items, long-tail."""
    return SyntheticSpec(n_sources=3182, n_items=20000, coverage="book",
                         n_cliques=60, clique_size=3, seed=seed)


def oracle_claim_probs(values: np.ndarray) -> np.ndarray:
    """Truth probability of each claim with oracle knowledge of the truth:
    value 0 (true) .95, any other .02, no claim 0."""
    return np.where(values == 0, 0.95,
                    np.where(values > 0, 0.02, 0.0)).astype(np.float32)


def new_sources(world: World, spec: SyntheticSpec, n_rows: int, seed,
                claims_per_source: np.ndarray | None = None):
    """``n_rows`` sources that arrive after ``world`` was made, drawn as
    ``synthetic_claims`` draws a source of it: an accuracy in [acc_low,
    acc_high], the coverage profile, its own claims; and with the share of
    copiers the spec plants (``n_cliques * (clique_size - 1) / n_sources``)
    a copier of a random source of the world with at least 20 claims,
    taking ``copy_selectivity`` of that source's claims over its own.
    Returns ``(values, accuracy, origins)``; ``origins[r]`` is the copied
    source or -1. ``claims_per_source`` (the world's, if known) saves
    counting them."""
    rng = np.random.default_rng(seed)
    corpus = world.values
    D = corpus.shape[1]
    if claims_per_source is None:
        claims_per_source = (corpus >= 0).sum(axis=1)
    originals = np.nonzero(claims_per_source >= 20)[0]
    share = spec.n_cliques * (spec.clique_size - 1) / spec.n_sources
    acc = rng.uniform(spec.acc_low, spec.acc_high, size=n_rows).astype(np.float32)
    cov = _coverage(rng, spec.coverage, n_rows)
    values = -np.ones((n_rows, D), dtype=np.int32)
    origins = np.full(n_rows, -1, dtype=np.int32)
    for r in range(n_rows):
        _own_claims(rng, values[r], cov[r], acc[r], spec.n_false)
        if rng.random() < share and originals.size:
            o = int(originals[rng.integers(0, originals.size)])
            o_idx = np.nonzero(corpus[o] >= 0)[0]
            take = o_idx[rng.random(o_idx.size) < spec.copy_selectivity]
            values[r, take] = corpus[o, take]
            origins[r] = o
    return values, acc, origins


#: Truth probabilities a vote gives are kept inside (P_CLIP, 1 - P_CLIP).
P_CLIP = 1e-3


def truth_table(values: np.ndarray, accuracy: np.ndarray, n_false: int,
                kind: str = "oracle") -> np.ndarray:
    """(D, n_false + 1) float32: the truth probability of each item's
    values. ``oracle``: .95 for the true value 0, .02 for a false one.
    ``vote``: one round of the accuracy-weighted vote of truth finding
    without copying (Dong, Berti-Equille, Srivastava, VLDB 2009), each
    provider of a value adding ln(n A / (1 - A)) to its count C and
    P(v) = exp(C(v)) / sum of exp(C) over the item's n_false + 1 values
    (those nobody provides count 0), clipped to (P_CLIP, 1 - P_CLIP)."""
    D = values.shape[1]
    if kind == "oracle":
        table = np.full((D, n_false + 1), 0.02, np.float32)
        table[:, 0] = 0.95
        return table
    if kind != "vote":
        raise ValueError(f"unknown claim probabilities {kind!r}")
    a = np.clip(accuracy.astype(np.float64), 1e-6, 1 - 1e-6)
    w = np.log(n_false * a / (1.0 - a))
    s, d = np.nonzero(values >= 0)
    key = d * (n_false + 1) + values[s, d]
    c = np.bincount(key, weights=w[s], minlength=D * (n_false + 1))
    c = c.reshape(D, n_false + 1)
    top = np.maximum(c.max(axis=1, keepdims=True), 0.0)
    e = np.exp(c - top)
    table = e / e.sum(axis=1, keepdims=True)
    return np.clip(table, P_CLIP, 1 - P_CLIP).astype(np.float32)


def claim_probs(values: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Each claim's truth probability from ``truth_table``; 0 where there
    is no claim."""
    at = np.arange(values.shape[1], dtype=np.int32) * np.int32(table.shape[1])
    p = table.ravel()[at + np.maximum(values, 0)]
    return np.where(values >= 0, p, np.float32(0.0))


# ---------------------------------------------------------------------------
# the seed's relabelling
# ---------------------------------------------------------------------------

@dataclass
class Relabel:
    """Permutations drawn from a run's seed: ``sources[new] = old``,
    ``items[new] = old``, and ``codes[d_old, v_old] = v_new`` for the
    false values (code 0, the true value, and -1 stay)."""

    sources: np.ndarray
    items: np.ndarray
    codes: np.ndarray

    def world(self, w: World) -> World:
        values = self.values(w.values[self.sources])
        inv = np.argsort(self.sources)
        copies = {tuple(sorted((int(inv[a]), int(inv[b])))) for a, b in w.copies}
        edges = [(int(inv[c]), int(inv[o])) for c, o in w.copy_edges]
        return World(values=values, accuracy=w.accuracy[self.sources],
                     copies=copies, copy_edges=edges)

    def values(self, v: np.ndarray) -> np.ndarray:
        """Rows already in the new source order: renumber items and codes."""
        cols = v[:, self.items]
        new = self.codes[self.items[None, :], np.maximum(cols, 0)]
        return np.where(cols < 0, -1, new).astype(np.int32)


def relabel(seed: int, n_sources: int, n_items: int, n_false: int) -> Relabel:
    """The permutations of one run's seed (any whole number ≥ 0)."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    codes = np.empty((n_items, n_false + 1), np.int32)
    codes[:, 0] = 0
    codes[:, 1:] = 1 + np.argsort(rng.random((n_items, n_false)), axis=1)
    return Relabel(sources=rng.permutation(n_sources),
                   items=rng.permutation(n_items), codes=codes)


__all__ = ["P_CLIP", "Relabel", "SyntheticSpec", "World", "book_full_spec",
           "claim_probs", "new_sources", "oracle_claim_probs", "relabel",
           "synthetic_claims", "truth_table"]
