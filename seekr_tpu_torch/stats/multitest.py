"""Multiple-comparison p-value corrections (numpy, no statsmodels).

Port of ``seekr_tpu/stats/multitest.py:22-247``.  A drop-in for
``statsmodels.stats.multitest.multipletests`` for the ten methods the reference
exposes (seekr/adj_pval.py:21-22): bonferroni, sidak, holm-sidak, holm,
simes-hochberg, hommel, fdr_bh, fdr_by, fdr_tsbh, fdr_tsbky.  Returns the same
4-tuple ``(reject, pvals_corrected, alphacSidak, alphacBonf)``.

From ``_NATIVE_SORT_MIN`` values up, the sort, the BH/BY scan and the unsort
scatter run in the host C++ library (``native``), bitwise equal to the numpy
path; ``SEEKR_TPU_HOST_SORT=numpy`` forces numpy, ``=native`` the library.
On a card the FDR pair on unsorted input runs there instead (``_fdr_torch``),
bitwise equal too; ``SEEKR_TPU_HOST_SORT`` does not touch that route.

``fdr_routes`` counts BH/BY corrections by the route that produced them:
``"device"`` (``_fdr_torch``), ``"native"`` (the C++ library) and ``"numpy"``;
the two-stage methods count each of their corrections.
"""

from __future__ import annotations

import numpy as np
import torch

from seekr_tpu_torch.utils.device import resolve_device

# Above this length the sort and the final unsort scatter go through the
# native multithreaded radix engine (native/src/sortops.cpp): at the size of an
# all-pairs p-value matrix they dominate the correction's wall time.
_NATIVE_SORT_MIN = 1 << 16


# The device route's scratch a value besides p itself, with room: at the sort's
# peak the float64 p, the sorted keys, their indices and the sort's own buffers
# are live (49 bytes a float64 value at 84.5 M values, p included, on an H100).
_DEVICE_BYTES_PER_VALUE = 64

fdr_routes = {"device": 0, "native": 0, "numpy": 0}


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


def _fdr_device(device, n: int, itemsize: int, free_bytes=None):
    """The card an unsorted BH/BY correction of ``n`` values of ``itemsize``
    bytes runs on, or None for the host path.

    ``device=None`` means the first card when CUDA is available and the host
    otherwise: ``multipletests`` has always run on the host, so unlike
    ``resolve_device`` it does not raise without CUDA.  Any other value is
    resolved as every entry point does, and only a CUDA device takes the card.
    Below ``_NATIVE_SORT_MIN`` values the host's sort is cheaper than the round
    trip, and a correction whose scratch exceeds ``free_bytes`` stays on the
    host; by default that is what the allocator can hand out: the card's free
    memory (``mem_get_info``) and what PyTorch's cache holds unused.
    """
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = resolve_device(device)
    if device.type != "cuda" or n < _NATIVE_SORT_MIN:
        return None
    if free_bytes is None:
        free_bytes = (torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device)
                      - torch.cuda.memory_allocated(device))
    return device if n * (itemsize + _DEVICE_BYTES_PER_VALUE) <= free_bytes else None


# rows of the device route's blocked prefix minimum
_PREFIX_MIN_ROW = 1024


def _prefix_min(x: torch.Tensor) -> torch.Tensor:
    """Running minimum of a 1-D tensor without NaN, exact on any device.

    ``torch.cummin`` of one long row is one thread block on a card, so the
    scan runs over rows of ``_PREFIX_MIN_ROW`` (the tail padded with +inf), and
    each row then takes the running minimum of the rows before it, itself a
    prefix minimum.  A minimum rounds nothing, so the blocking is exact.
    """
    n = x.shape[0]
    if n <= _PREFIX_MIN_ROW:
        return x.cummin(0).values
    rows = torch.nn.functional.pad(x, (0, -n % _PREFIX_MIN_ROW), value=float("inf"))
    rows = rows.view(-1, _PREFIX_MIN_ROW).cummin(1).values
    carry = _prefix_min(rows[:, -1])
    torch.minimum(rows[1:], carry[:-1, None], out=rows[1:])
    return rows.view(-1)[:n]


def _fdr_torch(p: torch.Tensor, alpha: float, by: bool = False):
    """Benjamini-Hochberg (or, with ``by``, Benjamini-Yekutieli) of an unsorted
    1-D float32 or float64 tensor, on its device.

    Returns ``(reject, corrected)`` in the input order (bool and float64, on
    the device), bitwise the numpy path's, or None when p holds a NaN: numpy
    spreads its NaN through the whole scan, and the host route decides.  The
    arithmetic is numpy's: the widened p sorted, divided by ``ecdf = i / n``
    (by ``i / n / harmonic`` for BY), the running minimum from the largest p
    down, the clip to [0, 1].  The sort is descending, so that running minimum
    is a prefix one; it need not be stable, since tied p get the same quotient
    minimum whatever their order.  ``reject`` is numpy's step-up rule: the last
    sorted p with ``p <= ecdf * alpha`` ends its tie group, so the rejected
    hypotheses are those with p up to it, whatever the order of ties.
    """
    dev = p.device
    p = p.to(torch.float64)  # exact: the bits of np.asarray(p, float64)
    n = p.shape[0]
    p_desc, order = torch.sort(p, descending=True)
    if torch.isnan(p_desc[0]):  # NaN sorts first here; waits for the sort
        return None

    def scalar(v):
        # a device tensor divisor: a CPU scalar would multiply by its reciprocal
        return torch.full((), v, dtype=torch.float64, device=dev)

    ecdf = torch.arange(n, 0, -1, dtype=torch.float64, device=dev).div_(scalar(float(n)))
    if by:
        ecdf.div_(scalar(_harmonic_sum(n)))
    below = p_desc <= ecdf * alpha
    last = torch.where(below, p_desc, float("-inf")).amax()
    reject = p <= last  # none below: last is -inf, which no p then equals
    del p, below
    corrected = _prefix_min(torch.div(p_desc, ecdf, out=ecdf))
    del p_desc, ecdf
    # numpy's clip gives +0.0 for -0.0; adding +0.0 does the same
    corrected.clamp_(0.0, 1.0).add_(0.0)
    out = torch.empty_like(corrected)
    out.scatter_(0, order, corrected)
    return reject, out


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
            fdr_routes["native"] += 1
            return reject, corrected
        except ValueError:  # the C side ran out of memory: numpy's turn
            pass
    fdr_routes["numpy"] += 1
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
                  is_sorted: bool = False, returnsorted: bool = False, device=None):
    """Test results and p-value correction for multiple tests.

    Mirrors the statsmodels call sites at seekr/adj_pval.py:81,100,119 (only
    element [1], the corrected p-values, is consumed there).  ``device``: where
    ``fdr_bh``/``fdr_by`` on unsorted input runs (``_fdr_device``); ``None``
    is the first card when there is one, else the host, and ``"cpu"`` the
    host.  Every route gives the same bits.
    """
    pvals = np.asarray(pvals)
    if pvals.dtype != np.float32:
        pvals = pvals.astype(np.float64, copy=False)
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

    fused_fdr = method in ("fdr_bh", "fdr_by") and not is_sorted and not returnsorted
    # the FDR pair on unsorted input, on a card: p goes there in its own dtype,
    # the corrected p and reject come back; a NaN or too little memory there
    # leaves it to the host
    dev = _fdr_device(device, n, pvals.itemsize) if fused_fdr else None
    if dev is not None:
        try:
            fdr = _fdr_torch(torch.from_numpy(pvals).to(dev), alpha,
                             by=method == "fdr_by")
        except torch.cuda.OutOfMemoryError:
            fdr = None
        if fdr is not None:
            fdr_routes["device"] += 1
            reject_full, corrected_full = (t.cpu().numpy() for t in fdr)
            return (reject_full.reshape(shape), corrected_full.reshape(shape),
                    alphac_sidak, alphac_bonf)
    pvals = pvals.astype(np.float64, copy=False)

    # on the host one native call sorts, corrects and unsorts; it reports NaNs
    # back (ValueError), and numpy then decides
    if fused_fdr and _use_native(n):
        from seekr_tpu_torch import native

        try:
            corrected_full, reject_full, _ = native.fdr_adjust(
                pvals, alpha, _harmonic_sum(n) if method == "fdr_by" else 0.0)
            fdr_routes["native"] += 1
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
