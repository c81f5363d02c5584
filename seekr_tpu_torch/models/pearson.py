"""Public pearson() -- all-pairs Pearson similarity of two count matrices.

Port of ``seekr_tpu/models/pearson.py``.  Reference parity: seekr/pearson.py:32-44
(row standardization with population std, inner product divided by the column
count, optional .npy save).  The GEMM runs on ``device``; inputs are host numpy
or tensors, the output is host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from seekr_tpu_torch.io.stream import STREAM_CELL_THRESHOLD
from seekr_tpu_torch.ops.pearson import pearson_blocked, pearson_device


def pearson(counts1, counts2, row_standardize: bool = True,
            outfile: str | None = None, device=None) -> np.ndarray:
    """Row-standardized Pearson correlation matrix, computed on ``device``.

    Tensors (e.g. from ``KmerCounter.get_counts_device``) are used where they
    lie; anything else is materialized as float32 numpy first.  A
    self-comparison (the same object, or host arrays of equal content) is made
    exactly symmetric from its upper triangle.
    """
    same = counts2 is counts1
    c1 = counts1 if isinstance(counts1, torch.Tensor) else np.asarray(counts1, dtype=np.float32)
    if not same and not isinstance(counts1, torch.Tensor) \
            and not isinstance(counts2, torch.Tensor) \
            and np.shape(counts1) == np.shape(counts2):
        # equal-content host arrays (two loads of one artifact) are a
        # self-comparison too: one standardize, exact symmetry
        same = _equal_content(np.asarray(counts1), np.asarray(counts2))
    c2 = c1 if same else (counts2 if isinstance(counts2, torch.Tensor)
                          else np.asarray(counts2, dtype=np.float32))
    m1, m2 = c1.shape[0], c2.shape[0]
    if m1 * m2 > STREAM_CELL_THRESHOLD:
        dist = pearson_blocked(c1, c2, row_standardize=row_standardize, device=device)
    else:
        dist = pearson_device(c1, c2, row_standardize=row_standardize,
                              device=device).cpu().numpy()
    if same:
        # self-similarity is exactly symmetric, like the reference's np.inner;
        # the canonical value is the upper triangle's
        mirror_upper_inplace(dist)
    if outfile:
        np.save(outfile, dist)
    return dist


def _equal_content(a1: np.ndarray, a2: np.ndarray) -> bool:
    """Same-shape content equality, NaN-tolerant, cheap on mismatches.

    A strided row probe rejects different matrices in O(m/8) rows; only a
    probe match pays the full comparison, in row chunks so the temporaries of
    ``equal_nan`` stay bounded.  Integer inputs do not take ``equal_nan``.
    """
    def _eq(x, y):
        try:
            return np.array_equal(x, y, equal_nan=True)
        except TypeError:
            return np.array_equal(x, y)

    if a1.ndim != 2:
        return _eq(a1, a2)
    rows = a1.shape[0]
    step = max(1, rows // 8)
    if not _eq(a1[::step], a2[::step]):
        return False
    per_row = a1.shape[1] or 1
    chunk = max(1, (1 << 24) // per_row)  # <= 16M elements of temporaries
    for i in range(0, rows, chunk):
        if not _eq(a1[i:i + chunk], a2[i:i + chunk]):
            return False
    return True


def mirror_upper_inplace(a: np.ndarray, block: int = 4096) -> None:
    """Copy the strict upper triangle over the lower, blockwise (no full-size
    temporary)."""
    m = a.shape[0]
    for i0 in range(0, m, block):
        i1 = min(i0 + block, m)
        if i0:
            a[i0:i1, :i0] = a[:i0, i0:i1].T
        # diagonal block: mirror its own strict upper triangle
        d = a[i0:i1, i0:i1]
        il = np.tril_indices(i1 - i0, -1)
        d[il] = d.T[il]
