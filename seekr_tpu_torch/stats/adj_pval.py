"""Multiple-comparison correction of a p-value matrix.

Port of ``seekr_tpu/stats/adj_pval.py:19-99`` (behavioural parity with
seekr/adj_pval.py:61-129), on a ``LabeledMatrix`` where the reference takes a
DataFrame:

  * a symmetric input (labels equal, and transpose-equal at 5 decimals with
    the diagonal excluded, seekr/adj_pval.py:53-59) -> only the upper triangle
    (k=1) is corrected; the lower triangle and the diagonal become NaN;
  * otherwise the full flattened matrix is corrected and reshaped back.
"""

from __future__ import annotations

import numpy as np

from seekr_tpu_torch.io.fast_csv import LabeledMatrix
from seekr_tpu_torch.stats.multitest import multipletests
from seekr_tpu_torch.utils.adj import triu_fill, triu_values


def _tiled_symmetric(values: np.ndarray, tile: int = 1024) -> bool:
    """Cache-blocked ``round(a, 5) == round(a, 5).T`` with NaN == NaN.

    Mirror tiles keep both operands cache-resident (a full-matrix transpose
    view is a strided walk over the whole array) and the test exits on the
    first asymmetric tile.  The diagonal compares with itself, so it never
    decides.
    """
    m = values.shape[0]
    r = np.round(values, 5)
    for i0 in range(0, m, tile):
        a_row = r[i0:i0 + tile]
        for j0 in range(i0, m, tile):
            a = a_row[:, j0:j0 + tile]
            bt = r[j0:j0 + tile, i0:i0 + tile].T
            eq = a == bt
            if not eq.all():
                if not (eq | (np.isnan(a) & np.isnan(bt))).all():
                    return False
    return True


def is_symmetric(pvals: LabeledMatrix) -> bool:
    """Transpose equality ignoring the diagonal, rounded to 5 decimals.

    The reference's ``rounded.equals(rounded.T)`` decision: the row and column
    labels must be equal, and the values 5-decimal transpose-equal with NaNs
    equal.
    """
    if pvals.index != pvals.columns:
        return False
    return _tiled_symmetric(pvals.values)


def adj_pval(pvals, method, alpha=0.05, outputname=None):
    """Corrected p-values as a float64 ``LabeledMatrix`` with ``pvals``' labels
    (and ``{outputname}.csv`` when asked), or None for an input that is not a
    labeled matrix."""
    if not isinstance(pvals, LabeledMatrix):
        print("The input pvals is not a dataframe. Please check the input.")
        return None

    if pvals.shape[0] == pvals.shape[1] and is_symmetric(pvals):
        print("The input pvals is a symmetric matrix. Only the upper "
              "triangle of the matrix (excluding diagonal) is used for "
              "multiple comparison correction.")
        adj = multipletests(triu_values(pvals.values), alpha=alpha, method=method)[1]
        out = triu_fill(pvals.shape[0], adj)
    else:
        print("The input pvals is not a symmetric matrix. The total matrix "
              "is used for multiple comparison correction.")
        adj = multipletests(np.ravel(pvals.values), alpha=alpha, method=method)[1]
        out = adj.reshape(pvals.shape)

    adjusted = LabeledMatrix(out, pvals.index, pvals.columns)
    if outputname:
        adjusted.to_csv(f"{outputname}.csv")
    return adjusted
