"""Launcher of the hand-written CUDA k-mer histogram (``csrc/count_kmers.cu``).

The port of ``seekr_tpu/ops/count_pallas.py::count_kmers_pallas`` (``:190-301``).
Two kernels cover every k the launcher takes, 1 <= k <= 15:

* ``count_kmers_smem`` (k <= 7), for the TPU's ``_kernel``: a shared-memory
  histogram per row;
* ``count_kmers_gmem`` (k >= 8), for ``_kernel_hiblocked`` and ``_kernel`` at
  k = 8: the histogram in global memory, then an in-place scale pass.

The TPU launcher's padding of rows to its row tile and of columns to its chunk,
and its int8 -> int32 cast, are TPU tiling workarounds: the kernels read int8
digits directly and mask their own edges.  The plain PyTorch version of the same
function is ``seekr_tpu_torch.ops.count.count_torch``.

``launches`` counts, per kernel, the calls that launched it; the wrapper adds one
there and nowhere else, so a caller can show which kernels a run went through.
"""

from __future__ import annotations

import torch

from seekr_tpu_torch.utils.build import cuda_error_string, load_library

SMEM_MAX_K = 7   # 4^7 int32 bins = 64 KB of shared memory; 4^8 is over 227 KB
MAX_K = 15       # window codes stay below 2^30

KERNELS = ("count_kmers_smem", "count_kmers_gmem")
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def split_hi_lo(k: int) -> tuple[int, int]:
    """(n_hi, n_lo) of the unflattened view: count_pallas.py's ``_split_lo``."""
    n_lo = 1 << min(7, 2 * k)
    return (1 << (2 * k)) // n_lo, n_lo


def kernel_for(k: int) -> str:
    return "count_kmers_smem" if k <= SMEM_MAX_K else "count_kmers_gmem"


def _check(bases: torch.Tensor, lengths: torch.Tensor, k: int) -> None:
    if bases.device.type != "cuda" or lengths.device != bases.device:
        raise ValueError(f"bases ({bases.device}) and lengths ({lengths.device}) "
                         "must lie on the same CUDA device")
    if bases.dtype != torch.int8 or lengths.dtype != torch.int32:
        raise TypeError(f"need int8 bases and int32 lengths, got {bases.dtype} "
                        f"and {lengths.dtype}")
    if bases.dim() != 2 or lengths.shape != (bases.shape[0],):
        raise ValueError(f"need bases [m, Lpad] and lengths [m], got "
                         f"{tuple(bases.shape)} and {tuple(lengths.shape)}")
    if not (bases.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("bases and lengths must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the CUDA count kernels take 1 <= k <= {MAX_K}, got {k}")
    if bases.shape[1] < k:
        raise ValueError("padded length must be >= k")


def count_kmers_cuda(bases: torch.Tensor, lengths: torch.Tensor, k: int,
                     scaled: bool = True, flat: bool = True) -> torch.Tensor:
    """[m, Lpad] int8 digits + [m] int32 lengths -> [m, 4^k] float32 counts.

    Counts per kb of windows when ``scaled``, raw integer window counts otherwise.
    ``flat=False`` returns a ``[m, n_hi, n_lo]`` view of the same buffer.
    """
    _check(bases, lengths, k)
    m, lpad = bases.shape
    n_bins = 1 << (2 * k)
    name = kernel_for(k)
    if name == "count_kmers_smem":
        out = torch.empty((m, n_bins), dtype=torch.float32, device=bases.device)
    else:
        # the kernel counts into this zeroed buffer as int32, then rewrites each
        # bin in place as float32: no separate m * 4^k scratch
        out = torch.zeros((m, n_bins), dtype=torch.int32, device=bases.device)
    if m:
        lib = load_library()
        stream = torch.cuda.current_stream(bases.device).cuda_stream
        err = getattr(lib, f"seekr_{name}")(
            bases.data_ptr(), lengths.data_ptr(), out.data_ptr(), m, lpad, k,
            int(scaled), bases.device.index or 0, stream)
        if err:
            raise RuntimeError(f"{name} failed to launch: CUDA error {err} "
                               f"({cuda_error_string(err)})")
        launches[name] += 1
    out = out.view(torch.float32)
    return out if flat else out.view(m, *split_hi_lo(k))
