"""``count_kmers_hiblocked`` (``csrc/count_kmers.cu``, 8 <= k <= 15): one launch
counts a padded ``[m, lpad]`` digit matrix, each block one slice of a row's
bins.  No floating-point operation bounds it; the bytes it must move are the
digits of every counted window (each read once, though each slice's block
reads its row again), the lengths, and the float32 ``[m, 4^k]`` output
(written once)."""

import numpy as np

KERNEL = r"count_hiblocked_kernel"


def work(inputs: dict):
    """``(flops, bytes)`` of one launch over ``inputs`` (``lengths``, ``lpad``, ``k``)."""
    lengths = np.asarray(inputs["lengths"], dtype=np.int64)
    k, lpad = int(inputs["k"]), int(inputs["lpad"])
    digits = np.where(lengths - (k - 1) > 0, np.minimum(lengths, lpad), 0).sum()
    return 0, int(digits + 4 * lengths.size + 4 * lengths.size * 4 ** k)
