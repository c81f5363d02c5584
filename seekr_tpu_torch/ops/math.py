"""Accurate float32 log2 built from exactly rounded operations.

Port of ``seekr_tpu/ops/math.py``.  The same construction gives the same bits on
every backend, so the port and seekr_tpu agree bitwise on normal floats:

    x = m * 2^e, m in [1, 2)            (bitcast exponent/mantissa split)
    fold m > sqrt(2) down one octave so m in [sqrt(2)/2, sqrt(2)]
    s = (m - 1) / (m + 1), |s| <= 0.1716
    log(m) = 2 * atanh(s) = 2s * (1 + s^2/3 + s^4/5 + s^6/7 + s^8/9)
    log2(x) = e + log(m) / ln(2)

Denormal inputs are delegated to ``torch.log2``; seekr_tpu's XLA-on-CPU flushes
them to zero, so the two differ there.  On the count path every input is >= 1
(``counts + 1``), so that difference never reaches a result.
"""

from __future__ import annotations

import torch

_INV_LN2 = 1.4426950408889634  # 1/ln(2)
_SQRT2 = 1.4142135623730951
_MIN_NORMAL = 1.17549435e-38


def accurate_log2(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """float32 log2 with ~2-3 ulp error; NaN/inf/non-positive delegate to torch.

    ``out``, where given, receives the result (it may not overlap ``x``)."""
    x = x.to(torch.float32)
    xi = x.view(torch.int32)
    e = ((xi >> 23) & 0xFF) - 127
    m = ((xi & 0x007FFFFF) | (127 << 23)).view(torch.float32)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = torch.where(big, e + 1, e).to(torch.float32)

    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    # atanh series, Horner; |s| <= 0.1716 so the s^10 tail is < 6e-9 relative
    p = s2 * (1.0 / 9.0) + 1.0 / 7.0
    p = p * s2 + 1.0 / 5.0
    p = p * s2 + 1.0 / 3.0
    p = p * s2 + 1.0
    log_m = 2.0 * s * p
    result = e + log_m * _INV_LN2

    # special values (x <= 0, inf, nan, denormal): torch's own log2
    normal = (x >= _MIN_NORMAL) & torch.isfinite(x)
    return torch.where(normal, result, torch.log2(x), out=out)


def log2_1p(x: torch.Tensor) -> torch.Tensor:
    """log2(x + 1) -- the reference's log2_norm transform (kmer_counts.py:189-192)."""
    return accurate_log2(x + 1.0)
