"""Matmul precision policy for the Pearson GEMMs.

Port of ``seekr_tpu/ops/precision.py``.  seekr_tpu measured a bf16-class GEMM at
3.6e-4 max error on its 2048x4096 Gram matrix, outside the reference's 1e-4
budget.  TF32 keeps the same 10-bit mantissa, so the Pearson GEMMs run in full
float32 whatever the caller set globally: ``pearson_precision()`` sets it for the
duration of a ``with`` block and restores the caller's setting afterwards.

``SEEKR_TPU_MATMUL_PRECISION`` is the same knob as in seekr_tpu: ``high`` (the
default) and ``highest`` both mean float32, because the TPU's bf16x3 ``HIGH`` has
no torch counterpart inside the budget; ``default`` means TF32.
"""

from __future__ import annotations

import contextlib
import os
import warnings

import torch

_warned_invalid = False


def tf32_requested() -> bool:
    """True when ``SEEKR_TPU_MATMUL_PRECISION=default`` asks for TF32."""
    name = os.environ.get("SEEKR_TPU_MATMUL_PRECISION", "high").lower()
    if name not in ("default", "high", "highest"):
        # a typo'd override silently running at float32 would make the knob
        # appear dead while the user debugs parity -- say so, once
        global _warned_invalid
        if not _warned_invalid:
            _warned_invalid = True
            warnings.warn(f"SEEKR_TPU_MATMUL_PRECISION={name!r} is not one of "
                          "default|high|highest; using 'high'")
        return False
    return name == "default"


def _legacy_precision() -> str | None:
    # torch >= 2.9 refuses to read the legacy setting once a caller has set
    # the new per-backend one (``torch.backends.cuda.matmul.fp32_precision``)
    try:
        return torch.get_float32_matmul_precision()
    except RuntimeError:
        return None


@contextlib.contextmanager
def pearson_precision():
    """Run the enclosed matmuls in float32 (or TF32 under ``default``)."""
    tf32 = tf32_requested()
    matmul = torch.backends.cuda.matmul
    prev_legacy = _legacy_precision()
    prev_new = getattr(matmul, "fp32_precision", None)
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        if prev_legacy is not None:
            torch.set_float32_matmul_precision(prev_legacy)
        if prev_new is not None:
            matmul.fp32_precision = prev_new
