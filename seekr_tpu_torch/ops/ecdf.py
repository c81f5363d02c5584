"""Empirical-CDF p-values.

Port of ``seekr_tpu/ops/ecdf.py``.  The reference computes
``p[i, j] = sum(fitres > sim[i, j]) / N`` in a Python loop per cell
(seekr/find_pval.py:157-164); here the background is sorted once and each cell
is one ``searchsorted``.  ``count > r`` equals ``N - (# elements <= r)`` and
``searchsorted(side='right')`` counts the elements ``<= r``, so the two agree
for every r, ties included.

  * ``SortedBackground`` / ``empirical_pvals``: host numpy in float64, the
    reference's comparison semantics (float32 sim against a float64
    background compares in float64); NaNs in the background count as not
    greater while the denominator keeps the full N.  find_pval uses
    ``SortedBackground``.
  * ``ecdf_sf``: the same survival function on the device
    (``torch.searchsorted(right=True)``), comparing in the background's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from seekr_tpu_torch.utils.profiler import span


def ecdf_sf(background_sorted: torch.Tensor, r: torch.Tensor,
            n_total=None) -> torch.Tensor:
    """Device empirical survival function P(X > r) per element of ``r``.

    background_sorted: [N] ascending, FINITE values only (drop NaNs before
    sorting: they would sort past every insertion point and count as
    greater).  ``n_total``: the ORIGINAL sample size, dropped NaNs included,
    which the reference keeps in the denominator; defaults to N.
    """
    n = background_sorted.shape[0]
    denom = n if n_total is None else int(n_total)
    le = torch.searchsorted(background_sorted, r.to(background_sorted.dtype).contiguous(),
                            right=True)
    return (n - le).to(torch.float32) / torch.tensor(float(denom), dtype=torch.float32,
                                                      device=le.device)


class SortedBackground:
    """Sort-once wrapper for repeated ECDF evaluations.

    The streamed find_pval evaluates per tile against an unchanged background,
    so the O(N log N) sort is hoisted here.  ``pvals`` is bitwise-identical to
    ``empirical_pvals`` on the same background.
    """

    def __init__(self, background):
        with span("ecdf.sort"):
            bkg = np.asarray(background, dtype=np.float64).ravel()
            self.n_total = len(bkg)
            self.finite = np.sort(bkg[~np.isnan(bkg)])

    def pvals(self, sim) -> np.ndarray:
        with span("ecdf.search"):
            r = np.asarray(sim, dtype=np.float64)
            le = np.searchsorted(self.finite, r, side="right")
            return ((len(self.finite) - le) / self.n_total).astype(np.float64)


def empirical_pvals(background, sim) -> np.ndarray:
    """Host p-values for a similarity matrix against a 1-D background sample
    (float64, the reference's ``mean(bkg > r)``).  Repeated evaluations against
    one background should build one :class:`SortedBackground` instead."""
    return SortedBackground(background).pvals(sim)
