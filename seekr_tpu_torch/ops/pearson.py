"""All-pairs Pearson correlation as a float32 GEMM.

Port of ``seekr_tpu/ops/pearson.py``.  Semantics follow the reference
(seekr/pearson.py:32-44): optionally row-standardize both matrices (per-row mean
and POPULATION std), then ``r = inner(c1, c2) / n_cols``.  The GEMM is
``torch.matmul`` -- seekr_tpu leaves it to XLA outside any kernel -- under
``pearson_precision()``, which keeps it in full float32.

For outputs too large for one buffer, ``pearson_blocked`` streams row blocks of
the left operand (``io/stream.stream_pearson``) into a host array.
``pearson_pairs`` computes only selected (i, j) pairs: a row gather and a
row-wise multiply-sum, for the sampled background of find_dist.
"""

from __future__ import annotations

import numpy as np
import torch

from seekr_tpu_torch.ops.precision import pearson_precision
from seekr_tpu_torch.utils.device import resolve_device


def as_float32(x, device: torch.device) -> torch.Tensor:
    """numpy or tensor input -> float32 tensor on ``device`` (no copy if it is one)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` as an IEEE divide: with a Python number CUDA multiplies by 1/n."""
    return x / torch.tensor(float(n), dtype=x.dtype, device=x.device)


def _row_standardize(c: torch.Tensor) -> torch.Tensor:
    # axis 0 = rows (sequences); every trailing axis is feature data, so an
    # unflattened [m, n_hi, n_lo] count tensor standardizes like its flat view
    feat = tuple(range(1, c.dim()))
    c = c.to(torch.float32)
    c = c - c.mean(dim=feat, keepdim=True)
    # population std (correction=0): torch's default is the unbiased one
    return c.div_(c.std(dim=feat, keepdim=True, correction=0))  # c is ours: in place


def matmul_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T / n_cols`` in float32 -- the one Pearson GEMM recipe."""
    with pearson_precision():
        return divide(a @ b.T, a.shape[1])


def pearson_graph(c: torch.Tensor) -> torch.Tensor:
    """Self-Pearson of one count tensor: row-standardize + Gram / n.

    Equivalent to ``pearson_device(c, c)``; accepts the unflattened 3-D count
    tensor too.
    """
    c = _row_standardize(c)
    c = c.reshape(c.shape[0], -1)
    return matmul_nt(c, c)


def pearson_device(counts1, counts2, row_standardize: bool = True,
                   device=None) -> torch.Tensor:
    """[m1, n] x [m2, n] -> [m1, m2] Pearson r matrix (float32, on ``device``)."""
    dev = resolve_device(device)
    c1 = as_float32(counts1, dev)
    c2 = as_float32(counts2, dev)
    if row_standardize:
        c1 = _row_standardize(c1)
        c2 = _row_standardize(c2)
    return matmul_nt(c1, c2)


def standardize_rows(counts, device=None) -> torch.Tensor:
    """Row-standardized copy on ``device`` (the Pearson operand form), for scoring
    many query batches against one fixed target matrix."""
    return _row_standardize(as_float32(counts, resolve_device(device)))


def pearson_against_standardized(counts1, targets_std, device=None) -> torch.Tensor:
    """[q, n] raw x [t, n] PRE-standardized -> [q, t] Pearson r matrix.

    Bitwise equal to ``pearson_device(counts1, targets)`` when
    ``targets_std = standardize_rows(targets)``.
    """
    dev = resolve_device(device)
    c1 = _row_standardize(as_float32(counts1, dev))
    return matmul_nt(c1, as_float32(targets_std, dev))


def pearson_pairs(counts, ii, jj, row_standardize: bool = True,
                  chunk: int = 65536, device=None) -> np.ndarray:
    """r-values of selected row pairs, without forming any r-matrix.

    ``out[t] = pearson(counts[ii[t]], counts[jj[t]])``: O(pairs * n) gather and
    multiply-sum on ``device`` instead of the O(m^2 n) GEMM -- the engine of the
    sampled find_dist, where only ``subset_size`` of the m(m-1)/2 pool is
    fitted (seekr/find_dist.py:166-171).  Rows are standardized once; pairs go
    in chunks of ``chunk``.  Indices are numpy-style (negative ones count from
    the end) and checked on the host first, so an out-of-range index raises
    ``IndexError`` as the reference's numpy indexing does.
    """
    dev = resolve_device(device)
    c = as_float32(counts, dev)
    if row_standardize:
        c = _row_standardize(c)
    ii = np.asarray(ii, dtype=np.int64).ravel()
    jj = np.asarray(jj, dtype=np.int64).ravel()
    m = int(c.shape[0])
    for name, arr in (("ii", ii), ("jj", jj)):
        if arr.size and (int(arr.min()) < -m or int(arr.max()) >= m):
            raise IndexError(
                f"{name} contains indices outside [-{m}, {m}) for a "
                f"{m}-row count matrix")
    ii = torch.as_tensor(np.where(ii < 0, ii + m, ii), device=dev)
    jj = torch.as_tensor(np.where(jj < 0, jj + m, jj), device=dev)
    out = torch.empty(ii.shape[0], dtype=torch.float32, device=dev)
    for start in range(0, ii.shape[0], chunk):
        a = c.index_select(0, ii[start:start + chunk])
        b = c.index_select(0, jj[start:start + chunk])
        out[start:start + chunk] = divide((a * b).sum(dim=1), c.shape[1])
    return out.cpu().numpy()


class _RowFiller:
    """Writer that fills a preallocated array with streamed row blocks."""

    def __init__(self, out: np.ndarray):
        self.out = out
        self.row = 0

    def append(self, block):
        block = np.asarray(block)
        self.out[self.row:self.row + block.shape[0]] = block
        self.row += block.shape[0]


def pearson_blocked(counts1, counts2, row_standardize: bool = True,
                    block_rows: int = 4096, device=None) -> np.ndarray:
    """Row-blocked Pearson into a host array, for outputs too large to hold on
    the device at once.  The blocked GEMM lives in ``io.stream.stream_pearson``.
    """
    from seekr_tpu_torch.io.stream import stream_pearson  # io.stream imports this module

    m1 = counts1.shape[0]
    m2 = counts2.shape[0]
    out = np.empty((m1, m2), dtype=np.float32)
    stream_pearson(counts1, counts2, _RowFiller(out), block_rows=block_rows,
                   row_standardize=row_standardize, device=device)
    return out
