"""The plain reference: seekr's k-mer profile, Pearson r, empirical p-values and
Benjamini-Hochberg, in float64 PyTorch, from the harness's own digits.

It imports nothing of the program under test and takes nothing it made: the
column statistics, the background null and every standardized operand are
worked out here again.  Semantics (seekr v2.0.2, kmer_counts.py, pearson.py,
find_pval.py, statsmodels' fdr_bh):

* digits 0..3 are the letters ``A G T C``; 4 (N, or padding) makes every window
  that holds it count nothing, while the row's denominator keeps it;
* a row's counts are per kb of windows: ``count * 1000 / (length - k + 1)``,
  the columns in ``itertools.product("AGTC", k)`` order (``sum digit_j 4^(k-1-j)``);
* Log2.post: centre by the column mean, divide by the column population std,
  add ``|min|`` of the matrix (of the request's own rows for a query), ``log2(x + 1)``;
* Pearson r: each row centred by its mean and divided by its population std,
  ``r = a @ b.T / n_columns``;
* the empirical p-value of r is the share of the null greater than r;
* BH: ``p_(i) * n / i``, the running minimum from the largest i down, at most 1.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def counts_per_kb(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                  rows_per_block: int = 1024) -> torch.Tensor:
    """``[m, 4^k]`` float64 counts per kb of windows of digit rows ``[m, L]``."""
    m, width = bases.shape
    n_win = width - k + 1
    out = torch.zeros((m, 4 ** k), dtype=F64, device=bases.device)
    pos = torch.arange(n_win, device=bases.device)
    for r0 in range(0, m, rows_per_block):
        d = bases[r0:r0 + rows_per_block].to(torch.int64)
        n = lengths[r0:r0 + rows_per_block].to(torch.int64)
        bad = (d < 0) | (d > 3)
        d = d.clamp(0, 3)
        code = torch.zeros((d.shape[0], n_win), dtype=torch.int64, device=d.device)
        hit = torch.zeros((d.shape[0], n_win), dtype=torch.bool, device=d.device)
        for j in range(k):
            code = code * 4 + d[:, j:j + n_win]
            hit |= bad[:, j:j + n_win]
        valid = ~hit & (pos[None, :] < (n - k + 1)[:, None])
        block = out[r0:r0 + rows_per_block]
        block.scatter_add_(1, code.masked_fill(~valid, 0), valid.to(F64))
        windows = (n - k + 1).to(F64)
        block *= torch.where(windows > 0, 1000.0 / windows.clamp(min=1), 0.0)[:, None]
    return out


def column_stats(counts: torch.Tensor):
    """Column mean and population std (of the centred columns)."""
    mean = counts.mean(dim=0)
    std = (counts - mean).pow(2).mean(dim=0).sqrt()
    return mean, std


def log2_post(counts: torch.Tensor, mean, std, per_row: bool = False) -> torch.Tensor:
    """Log2.post with given vectors; ``per_row`` shifts each row by its own
    ``|min|`` (each row a request of its own), else the whole matrix's."""
    z = (counts - mean) / std
    shift = z.amin(dim=1, keepdim=True).abs() if per_row else z.min().abs()
    return torch.log2(z + shift + 1.0)


def standardize_rows(x: torch.Tensor) -> torch.Tensor:
    x = x - x.mean(dim=1, keepdim=True)
    return x / x.pow(2).mean(dim=1, keepdim=True).sqrt()


def pearson(a_std: torch.Tensor, b_std: torch.Tensor) -> torch.Tensor:
    """r of row-standardized operands."""
    return a_std @ b_std.T / a_std.shape[1]


def triu_values(r: torch.Tensor) -> torch.Tensor:
    """The strict upper triangle, row by row."""
    i, j = torch.triu_indices(r.shape[0], r.shape[1], offset=1, device=r.device)
    return r[i, j]


def empirical_pvals(null_sorted: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Share of the (ascending, finite) null greater than each r."""
    n = null_sorted.numel()
    le = torch.searchsorted(null_sorted, r.to(F64).contiguous(), right=True)
    return (n - le).to(F64) / n


def bh(p: torch.Tensor) -> torch.Tensor:
    """Benjamini-Hochberg adjusted p-values of a flat vector."""
    n = p.numel()
    order = torch.argsort(p, stable=True)
    ranked = p[order] * n / torch.arange(1, n + 1, dtype=F64, device=p.device)
    ranked = torch.flip(torch.cummin(torch.flip(ranked, [0]), 0).values, [0]).clamp(max=1.0)
    out = torch.empty_like(ranked)
    out[order] = ranked
    return out
