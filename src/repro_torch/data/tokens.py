"""Synthetic multi-source token corpus and a prefetching batch pipeline.

The port of the JAX package's ``data/tokens.py``. The corpus mirrors the
paper's world: many sources provide overlapping documents; some sources
are copiers of low-quality originals, so naive uniform sampling over-trains
on duplicated junk. Documents are integer-sequence "facts": a clean
document is a modular arithmetic progression (learnable); a corrupted
document has a fraction of its tokens replaced with noise (the source's
error rate = 1 − accuracy). ``synthetic_corpus`` draws the same numbers
from the same seed as the JAX package (numpy throughout), and ``batches``
the same rows; it yields torch CPU tensors.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch


@dataclass
class TokenCorpus:
    docs: list                      # list of np.int32 arrays
    doc_source: np.ndarray          # (n_docs,) source id per document
    doc_topic: np.ndarray           # (n_docs,) shared topic id per document
    source_accuracy: np.ndarray     # (S,) planted quality
    copy_edges: list                # (copier, original)
    vocab_size: int = 512


def synthetic_corpus(n_sources=20, docs_per_source=40, doc_len=128,
                     vocab_size=512, n_copiers=6, seed=0) -> TokenCorpus:
    """Each source provides its own noisy *rendering* of shared topics;
    copiers re-host the original's rendering verbatim. Low-quality
    originals with copiers mean duplicated junk outweighs clean text under
    uniform sampling."""
    rng = np.random.default_rng(seed)
    acc = rng.uniform(0.4, 1.0, size=n_sources).astype(np.float32)
    originals = rng.choice(n_sources, size=n_copiers, replace=False)
    copier_of = {}
    pool = [s for s in range(n_sources) if s not in set(originals.tolist())]
    rng.shuffle(pool)
    for o in originals:
        if pool:
            copier_of[pool.pop()] = int(o)

    # shared topics: a clean base document each
    topics = []
    for _ in range(docs_per_source):
        start = rng.integers(0, vocab_size)
        stride = rng.integers(1, 5)
        topics.append(((start + stride * np.arange(doc_len)) % vocab_size
                       ).astype(np.int32))

    def render(t, s):
        noise = rng.random(doc_len) > acc[s]
        return np.where(noise, rng.integers(0, vocab_size, doc_len),
                        topics[t]).astype(np.int32)

    source_docs = {s: [render(t, s) for t in range(docs_per_source)]
                   for s in range(n_sources) if s not in copier_of}
    for c, o in copier_of.items():
        n_copy = int(0.8 * docs_per_source)
        source_docs[c] = ([source_docs[o][t].copy() for t in range(n_copy)]
                          + [render(t, c)
                             for t in range(n_copy, docs_per_source)])

    docs, doc_source, doc_topic = [], [], []
    for s in range(n_sources):
        for t, d in enumerate(source_docs[s]):
            docs.append(d)
            doc_source.append(s)
            doc_topic.append(t)
    return TokenCorpus(docs=docs, doc_source=np.asarray(doc_source),
                       doc_topic=np.asarray(doc_topic),
                       source_accuracy=acc,
                       copy_edges=list(copier_of.items()),
                       vocab_size=vocab_size)


def batches(corpus: TokenCorpus, batch_size: int, seq_len: int,
            source_weights: Optional[np.ndarray] = None,
            doc_weights: Optional[np.ndarray] = None,
            seed: int = 0) -> Iterator[dict]:
    """Weighted document sampling → {tokens, labels} batches of (batch_size,
    seq_len) int32 CPU tensors, forever. Every document must hold at least
    ``seq_len + 1`` tokens: where one is shorter this raises, where the JAX
    package silently yields shorter rows (ROADMAP C7)."""
    shortest = min(len(d) for d in corpus.docs)
    if seq_len + 1 > shortest:
        raise ValueError(f"seq_len {seq_len} needs documents of {seq_len + 1} "
                         f"tokens; the shortest has {shortest}")
    rng = np.random.default_rng(seed)
    n = len(corpus.docs)
    w = np.ones(n, dtype=np.float64)
    if source_weights is not None:
        w *= np.asarray(source_weights, np.float64)[corpus.doc_source]
    if doc_weights is not None:
        w *= np.asarray(doc_weights, np.float64)
    w /= w.sum()
    while True:
        idx = rng.choice(n, size=batch_size, p=w)
        rows = np.stack([corpus.docs[i][: seq_len + 1] for i in idx])
        yield {"tokens": torch.from_numpy(np.ascontiguousarray(rows[:, :-1])),
               "labels": torch.from_numpy(np.ascontiguousarray(rows[:, 1:]))}


class Prefetcher:
    """Double-buffered prefetch: a thread draws the next batches while the
    current step runs."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q = queue.Queue(maxsize=depth)
        self.it = it
        self._stop = False
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        for item in self.it:
            if self._stop:
                return
            self.q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop = True
