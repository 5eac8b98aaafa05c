"""The comparison that decides ``correct``: the program's answers against
the plain reference (``cdbench/reference``).

Two numbers, each with the limit of ``limits/<cell>.json``:

* ``decisions_wrong`` — pairs whose copying decision differs from the
  reference's. The program's decisions are exact (they equal the exact
  INDEX), so the limit is 0. Pairs whose reference log-odds lie within
  ``TIE`` of the boundary are left out: float32 and float64 sums may
  decide those either way.
* ``score_gap`` — the widest gap |C→ − C→_ref| / max(1, |C→_ref|) over the
  pairs whose reference log-odds lie within ``BAND`` of the boundary and
  that the program scored (C→ ≠ 0). The program rescores exactly every
  pair within its rescore margin (1 log-odds unit) of the boundary, so
  there its scores are exact to float32 round-off; away from it they carry
  the bucketed approximation by design.

The control: the reference in bfloat16 (``control_*``) put in the
program's place, judged the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from cdbench.reference import (
    CopyModel,
    pair_scores_dense,
    square_scores,
    z_scores,
)

#: log-odds band around the boundary whose pairs' scores are compared
BAND = 0.5
#: log-odds within which a decision is a tie of rounding
TIE = 1e-3


def _host(x):
    return x.cpu() if torch.is_tensor(x) else np.asarray(x)


def judge(c_prog, copy_prog, ref_fwd, ref_bwd, model: CopyModel,
          mask=None) -> dict:
    """The numbers of one answer: the program's (…, n) C→ and decisions
    against the reference's C→ and C← of the same pairs; ``mask`` marks
    the pairs that count (all by default)."""
    dev = ref_fwd.device
    c = torch.as_tensor(_host(c_prog), device=dev).double()
    cp = torch.as_tensor(_host(copy_prog), device=dev)
    z = z_scores(ref_fwd, ref_bwd, model)
    m = (torch.ones_like(cp) if mask is None else mask)
    wrong = (cp != (z >= 0)) & (z.abs() >= TIE) & m
    judged = (z.abs() < BAND) & (c != 0) & m
    rf = ref_fwd.double()
    gap = ((c - rf).abs() / rf.abs().clamp(min=1.0))[judged]
    return {"decisions_wrong": int(wrong.sum().item()),
            "score_gap": float(gap.max().item()) if gap.numel() else 0.0,
            "judged_pairs": int(judged.sum().item())}


def merge(numbers: list) -> dict:
    """The worst of several answers' numbers (counts summed)."""
    if not numbers:
        return {"decisions_wrong": 0, "score_gap": 0.0, "judged_pairs": 0}
    return {"decisions_wrong": sum(n["decisions_wrong"] for n in numbers),
            "score_gap": max(n["score_gap"] for n in numbers),
            "judged_pairs": sum(n["judged_pairs"] for n in numbers)}


def judge_square(c_prog, copy_prog, ref, model) -> dict:
    """A whole (S, S) answer against the reference's (S, S) C→."""
    off = ~torch.eye(ref.shape[0], dtype=torch.bool, device=ref.device)
    return judge(c_prog, copy_prog, ref, ref.T, model, mask=off)


def control_square(values, accuracy, p_claim, model, device):
    """The control's (S, S) answer: the reference in bfloat16."""
    c = square_scores(values, accuracy, p_claim, model,
                      dtype=torch.bfloat16, device=device).float()
    z = z_scores(c, c.T, model)
    copying = z >= 0
    copying.fill_diagonal_(False)
    return c.cpu().numpy(), copying.cpu().numpy()


def rows_reference(rows_v, rows_p, rows_a, corpus_v, corpus_p, corpus_a,
                   model, device, dtype=torch.float64):
    """(C→ row→corpus, C→ corpus→row, C→ row→row) for query rows, each
    against the corpus and against the rows of its own request."""
    fwd, bwd = pair_scores_dense(rows_v, rows_p, rows_a, corpus_v, corpus_p,
                                 corpus_a, model, dtype=dtype, device=device)
    intra, _ = pair_scores_dense(rows_v, rows_p, rows_a, rows_v, rows_p,
                                 rows_a, model, dtype=dtype, device=device)
    return fwd, bwd, intra


def judge_rows(c_vs_corpus, copy_vs_corpus, copy_intra, ref, model) -> dict:
    """A response's rows against ``rows_reference``: the corpus block (scores
    and decisions) and the request's own block (decisions)."""
    fwd, bwd, intra = ref
    out = judge(c_vs_corpus, copy_vs_corpus, fwd, bwd, model)
    off = ~torch.eye(intra.shape[0], dtype=torch.bool, device=intra.device)
    inner = judge(intra, copy_intra, intra, intra.T, model, mask=off)
    out["decisions_wrong"] += inner["decisions_wrong"]
    return out


def control_rows(ref_bf16, model) -> tuple:
    """The control's answer for a request, from ``rows_reference`` in
    bfloat16: (C→ row→corpus, decisions vs corpus, decisions within)."""
    fwd, bwd, intra = (x.float() for x in ref_bf16)
    copying = z_scores(fwd, bwd, model) >= 0
    intra_copy = z_scores(intra, intra.T, model) >= 0
    intra_copy.fill_diagonal_(False)
    return (fwd.cpu().numpy(), copying.cpu().numpy(),
            intra_copy.cpu().numpy())


__all__ = ["BAND", "TIE", "control_rows", "control_square", "judge",
           "judge_rows", "judge_square", "merge", "rows_reference",
           "square_scores"]
