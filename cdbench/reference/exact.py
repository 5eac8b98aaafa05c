"""Exact pair scores of "Scaling up Copy Detection" (ICDE 2015), §II.

C→[i, j] is the log-odds evidence that source i copies from source j, summed
over the items both provide:

* a shared value with truth probability P (Eq. 6):
  ln(1 − s + s · Pr(Φ(S_j)) / Pr(Φ | ⊥)), with
  Pr(Φ(S_j)) = P·A_j + (1 − P)(1 − A_j)                       (Eq. 4)
  Pr(Φ | ⊥) = P·A_i·A_j + (1 − P)(1 − A_i)(1 − A_j) / n       (Eq. 3)
* a different value: ln(1 − s)                                 (Eq. 8)

and the pair copies (Eq. 2) when ln(α/β) + logaddexp(C→, C←) ≥ 0, with
β = 1 − 2α. P is the truth probability of the value source i provides.

Nothing here imports the program: the reference takes the claims, the
accuracies and the claim probabilities as numpy or torch and works the rest
out itself. ``dtype`` is the precision of the per-claim arithmetic
(float64 for the reference; bfloat16 for the benchmark's control); sums
are float64 for float64 and float32 otherwise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

#: Ordered pairs of one batch of the sparse square (bounds the temporaries).
PAIR_CHUNK = 1 << 24
#: Items × corpus sources of one block of the dense row scores.
DENSE_CHUNK = 1 << 26


@dataclass(frozen=True)
class CopyModel:
    """The copy model's parameters: prior α, selectivity s, false values n."""

    alpha: float = 0.1
    s: float = 0.8
    n: float = 50.0

    @property
    def log_prior(self) -> float:
        """ln(α/β)."""
        return math.log(self.alpha / (1.0 - 2.0 * self.alpha))


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def same_value_score(p, a_copier, a_source, m: CopyModel):
    """Eq. 6 elementwise, in the dtype of its operands."""
    one = torch.ones((), dtype=p.dtype, device=p.device)
    phi = p * a_source + (one - p) * (one - a_source)
    ind = p * a_copier * a_source + (one - p) * (one - a_copier) * (one - a_source) / m.n
    return torch.log(one - m.s + m.s * (phi / ind))


def _ln1ms(m: CopyModel, dtype, device):
    return torch.log(torch.tensor(1.0 - m.s, dtype=torch.float64,
                                  device=device).to(dtype))


def square_scores(values, accuracy, p_claim, m: CopyModel, *,
                  dtype=torch.float64, device="cpu") -> torch.Tensor:
    """C→ over every ordered pair of the (S, D) world: (S, S), zero diagonal.

    Sparse in the claims: each (item, value) group adds its score to every
    ordered pair of its providers, and every shared item adds ln(1 − s)
    through the count of shared items, minus the shared values' share.
    """
    dev = torch.device(device)
    vals = torch.as_tensor(values, device=dev)
    acc = torch.as_tensor(accuracy, device=dev)
    p = torch.as_tensor(p_claim, device=dev)
    S, D = vals.shape
    out_t = _acc_dtype(dtype)
    prov = (vals >= 0)
    provf = prov.to(torch.float64)
    shared = provf @ provf.T                     # exact: counts below 2**53
    ln1ms = _ln1ms(m, dtype, dev).to(out_t)
    flat = (shared.to(out_t) * ln1ms).reshape(-1)
    del shared, provf

    src, item = torch.nonzero(prov, as_tuple=True)
    code = vals[src, item].to(torch.int64)
    key = item * (int(code.max().item()) + 1 if len(code) else 1) + code
    key, order = torch.sort(key, stable=True)
    src, item = src[order], item[order]
    _, counts = torch.unique_consecutive(key, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    keep = counts >= 2
    counts, starts = counts[keep], starts[keep]
    a_c = acc.to(dtype)
    p_c = p[src, item].to(dtype)
    sq = counts * counts
    ends = torch.cumsum(sq, 0)
    g0 = 0
    while g0 < len(counts):
        base = int(ends[g0 - 1].item()) if g0 else 0
        g1 = int(torch.searchsorted(ends, base + PAIR_CHUNK, right=True).item())
        g1 = max(g1, g0 + 1)
        n_g, st_g, sq_g = counts[g0:g1], starts[g0:g1], sq[g0:g1]
        gid = torch.repeat_interleave(torch.arange(len(n_g), device=dev), sq_g)
        local = torch.arange(len(gid), device=dev) - (torch.cumsum(sq_g, 0) - sq_g)[gid]
        a = st_g[gid] + local // n_g[gid]
        b = st_g[gid] + local % n_g[gid]
        off = a != b
        a, b = a[off], b[off]
        i, j = src[a], src[b]
        f = same_value_score(p_c[a], a_c[i], a_c[j], m).to(out_t) - ln1ms
        flat.index_add_(0, i * S + j, f)
        g0 = g1
    c = flat.reshape(S, S)
    c.fill_diagonal_(0.0)
    return c


def pair_scores_dense(rows_v, rows_p, rows_a, cols_v, cols_p, cols_a,
                      m: CopyModel, *, dtype=torch.float64, device="cpu"):
    """(C→[r, c], C→[c, r]) for every query row r against every column
    source c, each (R, C), over the items row r claims; dense in those
    items."""
    dev = torch.device(device)
    rv = torch.as_tensor(rows_v, device=dev)
    rp = torch.as_tensor(rows_p, device=dev)
    ra = torch.as_tensor(rows_a, device=dev).to(dtype)
    cv = torch.as_tensor(cols_v, device=dev)
    cp = torch.as_tensor(cols_p, device=dev)
    ca = torch.as_tensor(cols_a, device=dev).to(dtype)
    out_t = _acc_dtype(dtype)
    ln1ms = _ln1ms(m, dtype, dev).to(out_t)
    R, C = rv.shape[0], cv.shape[0]
    fwd = torch.zeros((R, C), dtype=out_t, device=dev)
    bwd = torch.zeros((R, C), dtype=out_t, device=dev)
    zero = torch.zeros((), dtype=out_t, device=dev)
    for r in range(R):
        items = torch.nonzero(rv[r] >= 0, as_tuple=True)[0]
        step = max(1, DENSE_CHUNK // max(C, 1))
        for k0 in range(0, len(items), step):
            it = items[k0:k0 + step]
            v_r, v_c = rv[r, it], cv[:, it]                 # (k,), (C, k)
            shared = v_c >= 0
            same = shared & (v_c == v_r[None, :])
            f_rc = same_value_score(rp[r, it].to(dtype)[None, :], ra[r],
                                    ca[:, None], m).to(out_t)
            f_cr = same_value_score(cp[:, it].to(dtype), ca[:, None],
                                    ra[r], m).to(out_t)
            diff = torch.where(shared & ~same, ln1ms, zero)
            fwd[r] += (torch.where(same, f_rc, zero) + diff).sum(dim=1)
            bwd[r] += (torch.where(same, f_cr, zero) + diff).sum(dim=1)
    return fwd, bwd


def z_scores(c_fwd, c_bwd, m: CopyModel) -> torch.Tensor:
    """ln(α/β) + logaddexp(C→, C←) in float64: ≥ 0 means copying."""
    return m.log_prior + torch.logaddexp(c_fwd.double(), c_bwd.double())


def decide(c_fwd, c_bwd, m: CopyModel) -> torch.Tensor:
    """Eq. 2's decision: the pair copies when Pr(⊥ | Φ) ≤ .5."""
    return z_scores(c_fwd, c_bwd, m) >= 0.0


__all__ = ["CopyModel", "decide", "pair_scores_dense", "same_value_score",
           "square_scores", "z_scores"]
