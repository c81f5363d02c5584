"""The Pearson Gram ``a @ a.T`` of the forward (``ops/pearson.gram``, cuBLAS):
``2 m^2 n`` operations for ``m`` rows of ``n = 4^k`` columns; the bytes are the
standardized float32 operand read once and the ``[m, m]`` float32 result
written once.  The same operations are counted whatever computes them."""

KERNEL = r"(?i)gemm|xmma|cutlass"


def work(inputs: dict):
    """``(flops, bytes)`` of one forward's Gram."""
    m, n = int(inputs["m"]), 4 ** int(inputs["k"])
    return 2 * m * m * n, 4 * (m * n + m * m)
