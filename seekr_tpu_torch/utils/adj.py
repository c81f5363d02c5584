"""Upper-triangle helpers for square similarity and p-value matrices.

Port of ``seekr_tpu/utils/adj.py:28-95``, the numpy paths (the native C++ ones
come with the port's host code).
"""

from __future__ import annotations

import numpy as np


def triu_values(mat: np.ndarray) -> np.ndarray:
    """Upper-triangle (k=1) values in row-major order.

    Identical output to ``mat[np.triu_indices(m, 1)]`` but via row-slice
    copies: the index-array route materializes two m(m-1)/2 int64 vectors and
    gathers one element at a time.
    """
    m = mat.shape[0]
    out = np.empty(m * (m - 1) // 2, dtype=mat.dtype)
    pos = 0
    for i in range(m - 1):
        row = mat[i, i + 1:]
        out[pos:pos + row.size] = row
        pos += row.size
    return out


def triu_fill(m: int, flat: np.ndarray, fill=np.nan) -> np.ndarray:
    """Scatter a row-major upper-triangle vector back into an m x m matrix.

    Inverse of :func:`triu_values`; everything outside the strict upper
    triangle becomes ``fill``.  An integer ``flat`` fills a float64 matrix, so
    the default NaN fill is not cast to an integer.
    """
    flat = np.asarray(flat)
    dtype = flat.dtype if np.issubdtype(flat.dtype, np.floating) else np.float64
    out = np.full((m, m), fill, dtype=dtype)
    pos = 0
    for i in range(m - 1):
        cnt = m - i - 1
        out[i, i + 1:] = flat[pos:pos + cnt]
        pos += cnt
    return out


def triu_index_to_ij(m: int, t) -> tuple:
    """Map row-major strict-upper-triangle flat indices to (i, j) pairs.

    Row i holds the m-1-i values (i, i+1)..(i, m-1) from flat offset
    i*m - i*(i+1)/2; a searchsorted on those [m] offsets inverts the layout
    without any m^2 structure.
    """
    t = np.asarray(t, dtype=np.int64)
    rows = np.arange(m, dtype=np.int64)
    offsets = rows * m - (rows * (rows + 1)) // 2
    i = np.searchsorted(offsets, t, side="right") - 1
    j = t - offsets[i] + i + 1
    return i, j
