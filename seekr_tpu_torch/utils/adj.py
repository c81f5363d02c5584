"""Upper-triangle helpers for square similarity and p-value matrices.

Port of ``seekr_tpu/utils/adj.py``.  A float64 C-contiguous matrix of
``_NATIVE_MIN_M`` rows or more is gathered and filled by the host C++ library
(``native.triu_values_f64``/``triu_fill_f64``), bitwise the numpy path's result;
``SEEKR_TPU_HOST_SORT`` overrides the size gate as in ``stats.multitest``.
"""

from __future__ import annotations

import numpy as np

# below this edge the numpy row-slice loops win on call overhead
_NATIVE_MIN_M = 2048


def _native_ok(arr, m: int) -> bool:
    """The gate of the C++ helpers: a C-contiguous float64 array, an edge of
    ``_NATIVE_MIN_M`` or more (or ``SEEKR_TPU_HOST_SORT``'s word)."""
    if (not isinstance(arr, np.ndarray) or arr.dtype != np.float64
            or not arr.flags.c_contiguous):
        return False
    from seekr_tpu_torch.native import host_stats_native_ok

    return host_stats_native_ok(m, _NATIVE_MIN_M)


def triu_values(mat: np.ndarray) -> np.ndarray:
    """Upper-triangle (k=1) values in row-major order.

    Identical output to ``mat[np.triu_indices(m, 1)]`` but via row-slice
    copies: the index-array route materializes two m(m-1)/2 int64 vectors and
    gathers one element at a time.
    """
    m = mat.shape[0]
    if _native_ok(mat, m):
        from seekr_tpu_torch import native

        try:
            return native.triu_values_f64(mat)
        except ValueError:  # not square, or the C side ran out of memory
            pass
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
    if _native_ok(flat, m):
        from seekr_tpu_torch import native

        try:
            return native.triu_fill_f64(m, flat, fill=fill)
        except (ValueError, TypeError):  # a wrong length, a fill not a float
            pass
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


def get_adj(adj):
    """Coerce an adjacency input (ndarray, labeled matrix or path) for graph use.

    A path ending in ``.npy`` loads as a bare ndarray; any other path is read
    as a labeled CSV (first column = index) into a float64
    ``io.fast_csv.LabeledMatrix``, where seekr_tpu reads a DataFrame.
    In-memory inputs are returned as they are (no copy).
    """
    if isinstance(adj, str) or hasattr(adj, "__fspath__"):
        path = str(adj)
        if path.endswith(".npy"):
            return np.load(path)
        from seekr_tpu_torch.io.fast_csv import read_labeled_csv

        return read_labeled_csv(path)
    return adj
