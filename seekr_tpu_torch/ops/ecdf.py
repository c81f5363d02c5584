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
    greater while the denominator keeps the full N.  find_pval uses it on
    the CPU, the service and the workflow everywhere.
  * ``DeviceSortedBackground``: the same p-values, bitwise, with the sort and
    the searches on a torch device (find_pval's empirical branch on a card).
  * ``ecdf_sf``: the same survival function on the device
    (``torch.searchsorted(right=True)``), comparing in the background's dtype
    and dividing in float32.

``evaluations`` counts the ``pvals`` calls of each placement: ``"host"`` for
``SortedBackground``, ``"device"`` for ``DeviceSortedBackground``.
"""

from __future__ import annotations

import numpy as np
import torch

from seekr_tpu_torch.utils.profiler import span

evaluations = {"device": 0, "host": 0}


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
            evaluations["host"] += 1
            r = np.asarray(sim, dtype=np.float64)
            le = np.searchsorted(self.finite, r, side="right")
            return ((len(self.finite) - le) / self.n_total).astype(np.float64)


class DeviceSortedBackground:
    """``SortedBackground`` with its sort and searches on ``device``.

    The null is copied there once in its own dtype (float32 stays float32;
    any other dtype is widened to float64 on the host first, as the host
    class does), its NaNs are dropped there and the rest is sorted there;
    ``n_total`` keeps the NaNs in the denominator.  ``pvals`` compares in
    float32 where the null and r are both float32 (widening both to float64
    is exact and keeps their order, so the counts are the host's) and in
    float64 otherwise, and divides in float64: its p-values are bitwise
    ``SortedBackground(background).pvals(sim).astype(sim.dtype)`` for a
    float32 or float64 ``sim``, ties, +-0.0 and NaN r (counted past every
    value, p = 0) included.
    """

    def __init__(self, background, device):
        with span("ecdf.sort"):
            bkg = np.asarray(background).ravel()
            if bkg.dtype != np.float32:
                bkg = bkg.astype(np.float64)
            null = torch.from_numpy(bkg).to(device)
            self.n_total = null.numel()
            # .values alone: the sort's int64 indices are freed at once
            self.finite = torch.sort(null[~torch.isnan(null)]).values

    def pvals(self, sim) -> np.ndarray:
        """p-values of ``sim`` (a tensor or an array, moved to the null's
        device) as a host array: float32 for float32 ``sim``, else float64."""
        with span("ecdf.search"):
            evaluations["device"] += 1
            r = torch.as_tensor(sim).to(self.finite.device)
            cmp = (torch.float32 if r.dtype == self.finite.dtype == torch.float32
                   else torch.float64)
            # a float32 null searched by float64 r is widened for this search only
            le = torch.searchsorted(self.finite.to(cmp), r.to(cmp).contiguous(), right=True)
            # a device tensor divisor: a CPU scalar would multiply by its reciprocal
            n_total = torch.full((), float(self.n_total), dtype=torch.float64,
                                 device=le.device)
            p = (self.finite.shape[0] - le).to(torch.float64) / n_total
            if r.dtype == torch.float32:
                p = p.to(torch.float32)  # rounds to nearest, as numpy's astype
            return p.cpu().numpy()


def empirical_pvals(background, sim) -> np.ndarray:
    """Host p-values for a similarity matrix against a 1-D background sample
    (float64, the reference's ``mean(bkg > r)``).  Repeated evaluations against
    one background should build one :class:`SortedBackground` instead."""
    return SortedBackground(background).pvals(sim)
