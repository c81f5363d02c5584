"""k-mer counting: the plain PyTorch version, the dispatch, and the host paths.

Port of ``seekr_tpu/ops/count.py``.  A k-mer window code is built from 2-bit base
digits, ``code = sum_j digit[i+j] * 4**(k-1-j)`` (the reference's
``itertools.product("AGTC", k)`` column order), each row's codes are histogrammed,
and the integer counts are scaled once by ``1000 / (len - k + 1)`` (counts per kb
of windows, reference kmer_counts.py:144-147).  Invalid windows (a base outside
the alphabet, e.g. N) count nothing while the denominator keeps them.

``count_graph`` sends a CUDA tensor to the hand-written kernel
(``ops/count_cuda.py``) and a CPU tensor to ``count_torch``.  The TPU dispatch
rules (the tiny-batch XLA path, the XLA path for k > 10) existed for the TPU's row
tile and are dropped: every k on a CUDA tensor goes through a kernel.

``count_kmers_host`` is the generic-alphabet numpy counter and the parity oracle.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from seekr_tpu_torch.ops.count_cuda import count_kmers_cuda, split_hi_lo
from seekr_tpu_torch.utils.device import resolve_device


def _scale(counts: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    nw = lengths.to(torch.int64) - (k - 1)
    # a tensor numerator: ``1000.0 / t`` would be reciprocal(t) * 1000, which is
    # not the IEEE divide seekr_tpu (and the CUDA kernel) computes
    num = torch.tensor(1000.0, dtype=torch.float32, device=counts.device)
    scale = torch.where(nw > 0, num / nw.clamp(min=1).to(torch.float32),
                        torch.zeros((), dtype=torch.float32, device=counts.device))
    return counts * scale[:, None]


def window_codes(bases: torch.Tensor, lengths: torch.Tensor,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[m, Lpad - k + 1] int64 codes of every window start, and the mask of the
    windows that count: inside the sequence, with no invalid digit (>= 4 or < 0)."""
    m, lpad = bases.shape
    if lpad < k:
        raise ValueError("padded length must be >= k")
    w = lpad - k + 1
    digits = bases.to(torch.int64)
    bad_digit = (digits < 0) | (digits >= 4)
    digits = digits.masked_fill(bad_digit, 0)
    code = torch.zeros((m, w), dtype=torch.int64, device=bases.device)
    bad = torch.zeros((m, w), dtype=torch.bool, device=bases.device)
    for j in range(k):
        code = code * 4 + digits[:, j:j + w]
        bad |= bad_digit[:, j:j + w]
    n_windows = lengths.to(torch.int64) - (k - 1)
    pos = torch.arange(w, device=bases.device)
    return code, (pos[None, :] < n_windows[:, None]) & ~bad


def count_torch(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                scaled: bool = True, flat: bool = True) -> torch.Tensor:
    """The plain version: [m, Lpad] int digits (>=4 invalid/pad) + [m] lengths.

    Returns [m, 4**k] float32 counts: per kb of windows when ``scaled``, raw
    integer window counts otherwise; ``flat=False`` returns an [m, n_hi, n_lo]
    view.  The contract of ``seekr_tpu/ops/count.py::_count_impl``, computed as
    window codes -> one ``bincount`` over row-offset codes -> scale.  Negative
    digits are invalid too.
    """
    m = bases.shape[0]
    n_bins = 1 << (2 * k)
    code, valid = window_codes(bases, lengths, k)
    row_offset = torch.arange(m, device=bases.device)[:, None] * n_bins
    hist = torch.bincount((code + row_offset)[valid], minlength=m * n_bins)
    counts = hist.view(m, n_bins).to(torch.float32)
    if scaled:
        counts = _scale(counts, lengths, k)
    return counts if flat else counts.view(m, *split_hi_lo(k))


def count_graph(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                scaled: bool = True, flat: bool = True) -> torch.Tensor:
    """k-mer counts on the tensors' device: the CUDA kernel or, on the CPU, the
    plain version.  ``flat=False`` returns the [m, n_hi, n_lo] view whose
    row-major bytes are the flat counts."""
    if bases.device.type == "cuda":
        return count_kmers_cuda(bases, lengths, k, scaled=scaled, flat=flat)
    if bases.device.type == "cpu":
        return count_torch(bases, lengths, k, scaled=scaled, flat=flat)
    raise ValueError(f"no k-mer count implementation for device {bases.device}")


def count_kmers_device(bases, lengths, k: int, flat: bool = True,
                       device=None) -> torch.Tensor:
    """Count k-mers of padded 2-bit encoded host arrays on ``device``."""
    dev = resolve_device(device)
    b = torch.as_tensor(np.ascontiguousarray(bases, dtype=np.int8), device=dev)
    n = torch.as_tensor(np.ascontiguousarray(lengths, dtype=np.int32), device=dev)
    return count_graph(b, n, k, flat=flat)


def split_long_digits(digits: np.ndarray, k: int, n_chunks: int):
    """Split one digit sequence into overlapping chunks for parallel count.

    Chunks tile the window-start positions with a (k-1)-base halo so every
    window is counted exactly once; tail padding is INVALID (4) so phantom
    windows contribute nothing.  Returns ([n_chunks, chunk + k - 1] int8,
    n_windows).
    """
    L = digits.shape[0]
    n_windows = L - k + 1
    # chunk >= 1 keeps the window width >= 1 even for an empty digit vector
    # (all-INVALID chunks count nothing; callers scale by n_windows <= 0 -> zeros)
    chunk = max(1, -(-L // n_chunks))
    padded = np.full(chunk * n_chunks + k - 1, 4, dtype=np.int8)
    padded[:L] = digits
    chunks = np.stack([padded[i * chunk: i * chunk + chunk + k - 1]
                       for i in range(n_chunks)])
    return chunks, n_windows


def count_kmers_long(digits: np.ndarray, k: int, target_chunk: int = 8192,
                     device=None) -> np.ndarray:
    """Histogram of ONE very long sequence via chunked counting.

    The sequence is cut into ~``target_chunk``-base chunks (halo of k-1 bases),
    counted as rows, and the partial histograms are summed: no padding of a 90 kb
    transcript to a 131k-column row.  Same result as counting it whole.
    """
    L = digits.shape[0]
    if L - k + 1 < 1:
        return np.zeros((1 << (2 * k),), dtype=np.float32)
    n_chunks = max(1, -(-L // target_chunk))
    rows = 1  # power-of-two chunk counts, as seekr_tpu keeps its shapes
    while rows < n_chunks:
        rows *= 2
    chunks, n_windows = split_long_digits(digits, k, rows)
    dev = resolve_device(device)
    lengths = torch.full((rows,), chunks.shape[1], dtype=torch.int32, device=dev)
    partial = count_graph(torch.as_tensor(chunks, device=dev), lengths, k,
                          scaled=False)
    total = partial.sum(dim=0)
    # seekr_tpu multiplies by the float32 rounding of the Python-float quotient
    scale = torch.tensor(1000.0 / n_windows, dtype=torch.float32, device=dev)
    return (total * scale).cpu().numpy()


def count_kmers_host(seqs: Sequence[str], k: int, alphabet: str = "AGTC") -> np.ndarray:
    """Vectorized numpy counter for arbitrary alphabets (parity oracle).

    Matches reference semantics exactly: every window over the sequence is in
    the denominator; only windows made purely of alphabet letters count.
    """
    a = len(alphabet)
    n_cols = a ** k
    lut = np.full(256, -1, dtype=np.int64)
    # uppercase only: the reference's k-mer map has uppercase keys, so
    # lowercase (soft-masked) windows are skipped with the denominator kept
    for digit, ch in enumerate(alphabet):
        lut[ord(ch)] = digit
    out = np.zeros((len(seqs), n_cols), dtype=np.float32)
    powers = a ** np.arange(k - 1, -1, -1, dtype=np.int64)
    for i, seq in enumerate(seqs):
        n = len(seq)
        w = n - k + 1
        if w < 1:
            continue
        digits = lut[np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)]
        windows = np.lib.stride_tricks.sliding_window_view(digits, k)
        valid = (windows >= 0).all(axis=1)
        codes = (windows * powers).sum(axis=1)[valid]
        row = np.zeros(n_cols, dtype=np.int64)
        np.add.at(row, codes, 1)
        out[i] = row.astype(np.float64) * (1000.0 / w)
    return out
