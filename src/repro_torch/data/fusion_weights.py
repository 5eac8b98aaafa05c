"""The paper's technique as a data-layer feature: copy-detection-derived
source weights and duplication discounts for LM training corpora.

The port of the JAX package's ``data/fusion_weights.py``. Documents are
hashed into (item, value) claims — each document span is a data item, the
span's content hash is the value — so sources that re-host the same
documents share values exactly like the paper's sources share attribute
values. Truth finding (``core/truthfind.py``, on ``device``) then yields
per-source accuracies and pairwise copy probabilities, which become:

  * source_weight(s)  = accuracy(s)            (low-quality sources sampled less)
  * doc_weight(d)     = 1 / (1 + #copiers of d's providing clique)
                        (mass of a document split across its re-hosters)

Span values are Python's ``hash(bytes) & 0x7FFFFFFF``, as in the JAX
package. That hash is salted per process (``PYTHONHASHSEED``), so the
compressed value ids equal the JAX package's only within one process.
Across processes the ids are permuted within an item: which sources share a
value is the same, so the weights are equal up to summation order.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.truthfind import truth_finding
from repro_torch.core.types import ClaimsDataset, CopyConfig
from repro_torch.data.tokens import TokenCorpus


def corpus_to_claims(corpus: TokenCorpus, span: int = 16) -> ClaimsDataset:
    """Content-hash each document's spans into claims.

    item = (topic, span index); value = hash of the span's tokens. Sources
    rendering the same topic independently disagree wherever either one
    corrupted a token (the value domain per item is effectively the paper's
    n false values); a copier re-hosting the original's rendering matches
    *exactly* on corrupted spans too — precisely the paper's sharing-false-
    values signal."""
    items = {}
    claims = {}
    for di, doc in enumerate(corpus.docs):
        s = int(corpus.doc_source[di])
        t = int(corpus.doc_topic[di])
        for sp in range(len(doc) // span):
            item_id = items.setdefault((t, sp), len(items))
            val = hash(doc[sp * span: (sp + 1) * span].tobytes()) & 0x7FFFFFFF
            claims[(s, item_id)] = val
    S = len(corpus.source_accuracy)
    D = len(items)
    values = -np.ones((S, D), dtype=np.int64)
    for (s, item_id), val in claims.items():
        values[s, item_id] = val
    # compress values per item to small ids, in ascending hash order
    out = -np.ones((S, D), dtype=np.int32)
    for d in range(D):
        vals = values[:, d]
        have = vals >= 0
        uniq = np.unique(vals[have])
        out[have, d] = np.searchsorted(uniq, vals[have])
    return ClaimsDataset(values=out,
                         accuracy=np.full(S, 0.8, np.float32))


def fusion_weights(corpus: TokenCorpus, cfg: CopyConfig | None = None,
                   detector: str = "hybrid", device=None):
    """→ (source_weights (S,), doc_weights (n_docs,), fusion result).

    Truth finding runs on ``device`` (``None`` → the card)."""
    cfg = cfg or CopyConfig(alpha=0.1, s=0.8, n=100.0)
    ds = corpus_to_claims(corpus)
    res = truth_finding(ds, cfg, detector=detector, max_rounds=6,
                        device=device)

    src_w = np.clip(res.accuracy, 0.05, None).astype(np.float64)

    # duplication discount: documents re-hosted by a copier clique share mass
    n_dup = np.zeros(len(corpus.docs))
    seen: dict = {}
    for di, doc in enumerate(corpus.docs):
        seen.setdefault(hash(doc.tobytes()), []).append(di)
    for dis in seen.values():
        if len(dis) > 1:
            n_dup[dis] = len(dis) - 1
    doc_w = 1.0 / (1.0 + n_dup)
    return src_w, doc_w, res


__all__ = ["corpus_to_claims", "fusion_weights"]
