"""Multiple-comparison p-value corrections (numpy, no statsmodels).

Port of ``seekr_tpu/stats/multitest.py:22-247``.  A drop-in for
``statsmodels.stats.multitest.multipletests`` for the ten methods the reference
exposes (seekr/adj_pval.py:21-22): bonferroni, sidak, holm-sidak, holm,
simes-hochberg, hommel, fdr_bh, fdr_by, fdr_tsbh, fdr_tsbky.  Returns the same
4-tuple ``(reject, pvals_corrected, alphacSidak, alphacBonf)``.

From ``_NATIVE_SORT_MIN`` values up, the sort, the BH/BY scan and the unsort
scatter run in the host C++ library (``native``), bitwise equal to the numpy
path; ``SEEKR_TPU_HOST_SORT=numpy`` forces numpy, ``=native`` the library.
"""

from __future__ import annotations

import numpy as np

# Above this length the sort and the final unsort scatter go through the
# native multithreaded radix engine (native/src/sortops.cpp): at the size of an
# all-pairs p-value matrix they dominate the correction's wall time.
_NATIVE_SORT_MIN = 1 << 16


def _use_native(n: int) -> bool:
    from seekr_tpu_torch.native import host_stats_native_ok

    return host_stats_native_ok(n, _NATIVE_SORT_MIN)


_METHOD_ALIASES = {
    "b": "bonferroni", "bonf": "bonferroni", "bonferroni": "bonferroni",
    "s": "sidak", "sidak": "sidak",
    "h": "holm", "holm": "holm",
    "hs": "holm-sidak", "holm-sidak": "holm-sidak",
    "sh": "simes-hochberg", "simes-hochberg": "simes-hochberg",
    "ho": "hommel", "hommel": "hommel",
    "fdr_bh": "fdr_bh", "fdr_i": "fdr_bh", "fdr_p": "fdr_bh",
    "fdr_by": "fdr_by", "fdr_n": "fdr_by", "fdr_c": "fdr_by",
    "fdr_tsbh": "fdr_tsbh", "fdr_2sbh": "fdr_tsbh",
    "fdr_tsbky": "fdr_tsbky", "fdr_2sbky": "fdr_tsbky",
}


def _harmonic_sum(n: int) -> float:
    """numpy's own pairwise ``sum(1/i)``, so BY is bitwise the same on the
    native and the numpy paths."""
    harmonic = np.arange(1.0, n + 1.0)
    np.reciprocal(harmonic, out=harmonic)
    return float(harmonic.sum())


def _fdr_correct(p_sorted: np.ndarray, alpha: float, by: bool = False):
    """Benjamini-Hochberg / Benjamini-Yekutieli on ascending-sorted p.

    Buffer-reusing: the ecdf buffer is built in place and recycled for the
    rejection threshold, and the accumulate/clip run on reversed views of one
    quotient buffer.  The arithmetic order is statsmodels'.  Large vectors take
    the native suffix-min scan (bitwise the same), unless a NaN sits at the
    sorted tail: NaN poisons numpy's accumulate, and that is the semantics.
    """
    n = len(p_sorted)
    if n and _use_native(n) and not np.isnan(p_sorted[-1]):
        from seekr_tpu_torch import native

        try:
            corrected, n_reject = native.fdr_sorted(p_sorted, alpha,
                                                    _harmonic_sum(n) if by else 0.0)
            reject = np.zeros(n, dtype=bool)
            reject[:n_reject] = True
            return reject, corrected
        except ValueError:  # the C side ran out of memory: numpy's turn
            pass
    ecdf = np.arange(1.0, n + 1.0)
    ecdf /= n
    if by:
        ecdf /= _harmonic_sum(n)
    corrected = p_sorted / ecdf
    np.minimum.accumulate(corrected[::-1], out=corrected[::-1])
    np.clip(corrected, 0, 1, out=corrected)
    ecdf *= alpha  # the ecdf buffer becomes the rejection threshold
    below = p_sorted <= ecdf
    reject = np.zeros(n, dtype=bool)
    if below.any():
        reject[: below.nonzero()[0].max() + 1] = True
    return reject, corrected


def _hommel(p_sorted: np.ndarray):
    """Hommel (1988) adjusted p-values; formulation of R's p.adjust."""
    n = len(p_sorted)
    q = p_sorted.copy()
    pa = p_sorted.copy()
    for m in range(n, 1, -1):
        i1 = np.arange(n - m + 1)
        i2 = np.arange(n - m + 1, n)
        q1 = np.min(m * p_sorted[i2] / np.arange(2, m + 1))
        q[i1] = np.minimum(m * p_sorted[i1], q1)
        q[i2] = q1
        pa = np.maximum(pa, q)
    return np.clip(pa, 0, 1)


def _step_down_reject(notreject: np.ndarray) -> np.ndarray:
    """Reject every hypothesis before the first one not rejected."""
    reject = np.ones(len(notreject), dtype=bool)
    nr = np.nonzero(notreject)[0]
    if nr.size:
        reject[nr[0]:] = False
    return reject


def multipletests(pvals, alpha: float = 0.05, method: str = "fdr_bh",
                  is_sorted: bool = False, returnsorted: bool = False):
    """Test results and p-value correction for multiple tests.

    Mirrors the statsmodels call sites at seekr/adj_pval.py:81,100,119 (only
    element [1], the corrected p-values, is consumed there).
    """
    pvals = np.asarray(pvals, dtype=np.float64)
    shape = pvals.shape
    pvals = pvals.ravel()
    n = len(pvals)
    method = _METHOD_ALIASES.get(str(method).lower())
    if method is None:
        raise ValueError("method not recognized")
    if n == 0:
        # e.g. the empty upper triangle of a 1x1 symmetric p-value matrix;
        # statsmodels returns empties too
        empty = np.empty(shape)
        return empty.astype(bool), empty, np.nan, np.nan

    alphac_sidak = 1.0 - (1.0 - alpha) ** (1.0 / n)
    alphac_bonf = alpha / n

    # the FDR pair on unsorted input: one native call sorts, corrects and
    # unsorts; it reports NaNs back (ValueError), and numpy then decides
    if (method in ("fdr_bh", "fdr_by") and not is_sorted and not returnsorted
            and _use_native(n)):
        from seekr_tpu_torch import native

        try:
            corrected_full, reject_full, _ = native.fdr_adjust(
                pvals, alpha, _harmonic_sum(n) if method == "fdr_by" else 0.0)
            return (reject_full.reshape(shape), corrected_full.reshape(shape),
                    alphac_sidak, alphac_bonf)
        except ValueError:
            pass

    if is_sorted:
        order = np.arange(n)
        p_sorted = pvals
    else:
        # stable in both paths: ties keep input order (every method gives tied
        # p-values the same corrected value, so only tie-boundary `reject`
        # bits, unused by adj_pval, could depend on it; the native sort also
        # puts -0.0 before +0.0, which compare equal)
        order = None
        if _use_native(n) and not np.isnan(pvals).any():
            from seekr_tpu_torch import native

            try:
                order, p_sorted = native.argsort_f64(pvals)
            except ValueError:
                order = None
        if order is None:
            order = np.argsort(pvals, kind="stable")
            p_sorted = pvals[order]

    if method == "bonferroni":
        corrected = np.clip(p_sorted * n, 0, 1)
        reject = p_sorted <= alphac_bonf
    elif method == "sidak":
        corrected = np.clip(-np.expm1(n * np.log1p(-p_sorted)), 0, 1)
        reject = p_sorted <= alphac_sidak
    elif method == "holm":
        factors = np.arange(n, 0, -1, dtype=np.float64)  # n, n-1, ..., 1
        corrected = np.clip(np.maximum.accumulate(p_sorted * factors), 0, 1)
        reject = _step_down_reject(p_sorted > alpha / factors)
    elif method == "holm-sidak":
        factors = np.arange(n, 0, -1, dtype=np.float64)
        corrected = np.maximum.accumulate(-np.expm1(factors * np.log1p(-p_sorted)))
        corrected = np.clip(corrected, 0, 1)
        reject = _step_down_reject(p_sorted > 1.0 - (1.0 - alpha) ** (1.0 / factors))
    elif method == "simes-hochberg":
        factors = np.arange(n, 0, -1, dtype=np.float64)
        corrected = np.clip(np.minimum.accumulate((p_sorted * factors)[::-1])[::-1], 0, 1)
        below = p_sorted <= alpha / factors
        reject = np.zeros(n, dtype=bool)
        if below.any():
            reject[: below.nonzero()[0].max() + 1] = True
    elif method == "hommel":
        corrected = _hommel(p_sorted)
        reject = corrected <= alpha
    elif method == "fdr_bh":
        reject, corrected = _fdr_correct(p_sorted, alpha, by=False)
    elif method == "fdr_by":
        reject, corrected = _fdr_correct(p_sorted, alpha, by=True)
    else:  # fdr_tsbh / fdr_tsbky -- two-stage adaptive FDR
        # bky runs at alpha/(1+alpha) and scales corrected p back by
        # (1+alpha), as statsmodels' fdrcorrection_twostage does
        bky = method == "fdr_tsbky"
        alpha_prime = alpha / (1 + alpha) if bky else alpha
        post = (1 + alpha) if bky else 1.0
        rej1, corr1 = _fdr_correct(p_sorted, alpha_prime, by=False)
        r1 = int(rej1.sum())
        if r1 == 0 or r1 == n:
            reject, corrected = rej1, np.clip(corr1 * post, 0, 1)
        else:
            ntests0 = n - r1  # estimated number of true nulls
            corrected = np.clip(corr1 * post * ntests0 / n, 0, 1)
            reject, _ = _fdr_correct(p_sorted, alpha_prime * n / ntests0, by=False)

    if returnsorted:
        return reject, corrected, alphac_sidak, alphac_bonf
    if is_sorted:
        # the order is the identity: no unsort scatter
        return (reject.reshape(shape), corrected.reshape(shape),
                alphac_sidak, alphac_bonf)

    corrected_full = None
    if _use_native(n):
        from seekr_tpu_torch import native

        try:
            corrected_full, reject_u8 = native.scatter_by_order(corrected, order,
                                                                flags=reject)
            reject_full = reject_u8.view(bool)
        except ValueError:
            corrected_full = None
    if corrected_full is None:
        corrected_full = np.empty_like(corrected)
        corrected_full[order] = corrected
        reject_full = np.empty_like(reject)
        reject_full[order] = reject
    return (reject_full.reshape(shape), corrected_full.reshape(shape),
            alphac_sidak, alphac_bonf)
