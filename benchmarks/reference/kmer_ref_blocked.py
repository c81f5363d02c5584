"""The plain reference of ``kmer_ref.py``, column-blocked and in place, for
count matrices too wide to copy: seekr's k-mer profile, Pearson r, empirical
p-values and Benjamini-Hochberg, in float64 PyTorch, from the harness's own
digits.

It has ``kmer_ref.py``'s functions, in its semantics (seekr v2.0.2,
kmer_counts.py, pearson.py, find_pval.py, statsmodels' fdr_bh; ``kmer_ref.py``
states them), and imports nothing of the program under test.  Three differ in
how they hold memory, not in what they compute:

* ``column_stats`` works through ``BLOCK`` columns at a time;
* ``log2_post`` and ``standardize_rows`` overwrite the matrix they are given,
  block by block, and return it.  ``log2_post``'s shift is the min of the
  blocks' minima, a NaN in any block carried (as one ``min``), and a row's
  mean and mean square are summed over its blocks.

So a check that runs ``standardize_rows(log2_post(c, *column_stats(c)))``
holds the float64 counts and one block's temporaries: at k = 9 and 13,000
rows, 27.3 GB and 0.43 GB, where the unblocked functions make several full
copies.
"""

from __future__ import annotations

import torch

F64 = torch.float64
BLOCK = 4096  # columns of one block


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


def _blocks(n_cols: int):
    return [slice(c, c + BLOCK) for c in range(0, n_cols, BLOCK)]


def column_stats(counts: torch.Tensor):
    """Column mean and population std (of the centred columns)."""
    means, stds = [], []
    for cols in _blocks(counts.shape[1]):
        block = counts[:, cols]
        mean = block.mean(dim=0)
        means.append(mean)
        stds.append((block - mean).pow(2).mean(dim=0).sqrt())
    return torch.cat(means), torch.cat(stds)


def log2_post(counts: torch.Tensor, mean, std, per_row: bool = False) -> torch.Tensor:
    """Log2.post with given vectors, in place on ``counts``; ``per_row`` shifts
    each row by its own ``|min|`` (each row a request of its own), else the
    whole matrix's."""
    blocks = _blocks(counts.shape[1])
    minima = []
    for cols in blocks:
        z = counts[:, cols].sub_(mean[cols]).div_(std[cols])
        minima.append(z.amin(dim=1, keepdim=True) if per_row else z.min())
    if per_row:
        shift = minima[0]
        for m in minima[1:]:
            shift = torch.minimum(shift, m)  # carries a NaN
        shift = shift.abs()
    else:
        shift = torch.stack(minima).min().abs()
    for cols in blocks:
        counts[:, cols].add_(shift).add_(1.0).log2_()
    return counts


def standardize_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row centred by its mean and divided by its population std, in place."""
    blocks = _blocks(x.shape[1])
    total = torch.zeros(x.shape[0], 1, dtype=x.dtype, device=x.device)
    for cols in blocks:
        total += x[:, cols].sum(dim=1, keepdim=True)
    mean = total / x.shape[1]
    total.zero_()
    for cols in blocks:
        total += x[:, cols].sub_(mean).pow(2).sum(dim=1, keepdim=True)
    std = (total / x.shape[1]).sqrt()
    for cols in blocks:
        x[:, cols].div_(std)
    return x


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
