"""Launcher of the hand-written CUDA epilogue of the forward's operand (``csrc/epilogue.cu``).

No TPU kernel is replaced: seekr_tpu's normalize and Pearson are plain XLA.  On the
H100 their PyTorch composition, some forty elementwise launches over the
``[m, 4^k]`` operand, took about half of every all-pairs forward at a few percent
of HBM bandwidth, so the forward's epilogue became four kernels, each one pass
over one ``GEMM_CHUNK``-column block of the row-major buffer:

* ``epilogue_column_stats`` (``Normalize.stats``): the normalize chain's column
  mean and population std in float64 (one read), and the running minimum that
  gives Log2.post's shift;
* ``epilogue_normalize`` (``Normalize.apply``): the chain's elementwise steps in
  place (one read, one write), each element bitwise the chain's given the same
  statistics and shift;
* ``epilogue_row_stats`` (``row_moments``): each row's float64 moments for the
  row standardization (one read);
* ``epilogue_standardize_split`` (``standardize_split``): the standardized rows
  split into the split Gram's TF32 halves (one read, two writes); the
  standardized operand itself is never written.

What bounds them is bytes: at k = 6 the operand is 13,000 x 4,096 float32 (213 MB,
0.064 ms a pass at 3.35 TB/s), and the four passes move ~1.5 GB.

Beside each launcher is its plain PyTorch twin with the same arithmetic
(``NormalizePlain``, ``row_moments_plain``, ``standardize_split_plain``): float64
statistics from the same sums about the same pivots, then the chain's float32 steps.
The twins run anywhere; the launchers take CUDA tensors only and launch or raise.
Which callers take the kernels is the callers' choice (``ops/normalize.py``,
``ops/pearson.py``): ``takes`` says what the kernels can take.

``launches`` counts, per kernel, the calls that launched it.
"""

from __future__ import annotations

import math

import torch

from seekr_tpu_torch.ops.math import accurate_log2
from seekr_tpu_torch.utils.build import cuda_error_string, load_library

KERNELS = ("epilogue_column_stats", "epilogue_normalize", "epilogue_row_stats",
           "epilogue_standardize_split")
launches = dict.fromkeys(KERNELS, 0)

SKIP, GIVEN, COMPUTED = 0, 1, 2  # a statistic's mode, as the kernels number it

# (device index, stream) -> the zeroed counters of the column-statistics launches
_counters: dict = {}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def takes(x: torch.Tensor, *stats) -> bool:
    """Whether the kernels take ``x`` as their ``[m, n]`` buffer (flattened past
    the first axis), and each of ``stats`` (None, False, or a given vector): a
    contiguous float32 CUDA tensor with rows, a width that is a multiple of 4 and
    16-byte aligned rows; given vectors of ``n`` values on the same card."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() >= 2
            and x.is_contiguous() and x.shape[0] >= 1 and _aligned(x)):
        return False
    n = math.prod(x.shape[1:])
    if n < 4 or n % 4:
        return False
    return all(v is None or v is False or (isinstance(v, torch.Tensor) and v.device == x.device
                                           and v.numel() == n and v.is_floating_point())
               for v in stats)


def _check(x: torch.Tensor) -> None:
    if not takes(x) or x.dim() != 2:
        raise ValueError(f"the epilogue kernels take a contiguous, 16-byte aligned float32 "
                         f"[m, n] CUDA tensor with m >= 1 and n a multiple of 4, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")


def _launch(name: str, device: torch.device, *args) -> None:
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, f"seekr_{name}")(*args, device.index or 0, stream)
    if err:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err} "
                           f"({cuda_error_string(err)})")
    launches[name] += 1


def _ptr(v: torch.Tensor | None, wanted: bool = True):
    """``v``'s address where wanted and present, else None (a null pointer)."""
    return v.data_ptr() if wanted and v is not None else None


def _span(x: torch.Tensor, cols: slice) -> tuple[int, int]:
    """(first column, width) of the block ``cols`` of ``x``'s columns."""
    first, stop, _ = cols.indices(x.shape[1])
    return first, stop - first


def _counters_of(device: torch.device, tiles: int) -> torch.Tensor:
    """The zeroed counters the column-statistics launches on the current stream
    share; each launch leaves them zero."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    counters = _counters.get(key)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 64), dtype=torch.int32, device=device)
        _counters[key] = counters
    return counters


def stats_from_moments(s: torch.Tensor, q: torch.Tensor, n: int, pivot: torch.Tensor):
    """float32 (mean, population std) of ``n`` values from the float64 sums ``s``
    of their differences from ``pivot`` and ``q`` of their squares: the
    kernels' arithmetic, operation for operation (a variance that rounds below
    0 is 0; NaN carries)."""
    count = torch.full((), float(n), dtype=torch.float64, device=s.device)
    mean = s / count  # a tensor divisor: an IEEE divide on the card too
    var = (q / count - mean * mean).clamp_(min=0.0)
    return (pivot.double() + mean).float(), var.sqrt().float()


def _nan_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, b]).min()


class Normalize:
    """The normalize chain in place on the buffer ``x`` [m, n] (float32, CUDA),
    by column blocks: ``stats(index, cols)`` for every block in order, then
    ``apply(cols)`` for every block.

    ``mean``/``std``: None computes the column statistic, False skips the step,
    a vector of ``n`` values is used as given (as float32).  ``pre``/``post``:
    Log2.pre's ``log2(x + 1)`` first, Log2.post's shift and ``log2`` last.
    ``self.mean``/``self.std`` are the flat float32 statistics used (None where
    skipped).  ``blocks`` are the column slices the caller will hand.
    """

    def __init__(self, x: torch.Tensor, blocks: list, mean, std, pre: bool, post: bool):
        self.x, self.pre, self.post = x, bool(pre), bool(post)
        self.mean_mode, self.mean = self._vector(mean)
        self.std_mode, self.std = self._vector(std)
        computed = COMPUTED in (self.mean_mode, self.std_mode)
        self.needs_stats = computed or self.post
        self.needs_apply = self.pre or self.post or self.mean is not None or self.std is not None
        self.running = torch.empty(len(blocks), dtype=torch.float32, device=x.device)
        self._widest = max(_span(x, cols)[1] for cols in blocks)
        self._scratch = None

    def _vector(self, v):
        n = self.x.shape[1]
        if v is None:
            return COMPUTED, torch.empty(n, dtype=torch.float32, device=self.x.device)
        if v is False:
            return SKIP, None
        v = v.to(device=self.x.device, dtype=torch.float32).reshape(-1)
        if not (v.is_contiguous() and _aligned(v)):
            v = v.clone(memory_format=torch.contiguous_format)
        return GIVEN, v

    def stats(self, index: int, cols: slice) -> None:
        """Block ``index``'s computed statistics, and (Log2.post) the minimum of
        the standardized values over blocks 0..index into ``running[index]``."""
        x = self.x
        _check(x)
        m, n = x.shape
        c0, width = _span(x, cols)
        lib = load_library()
        if self._scratch is None:  # one scratch for every block: they run in stream order
            self._scratch = torch.empty(lib.seekr_epilogue_scratch_bytes(m, self._widest),
                                        dtype=torch.uint8, device=x.device)
        counters = _counters_of(x.device, lib.seekr_epilogue_counters(width))
        _launch("epilogue_column_stats", x.device, x.data_ptr(), m, n, c0, width,
                int(self.pre), self.mean_mode, self.std_mode, int(self.post),
                _ptr(self.mean, self.mean_mode == GIVEN), _ptr(self.std, self.std_mode == GIVEN),
                _ptr(self.mean, self.mean_mode == COMPUTED),
                _ptr(self.std, self.std_mode == COMPUTED),
                self._scratch.data_ptr(), counters.data_ptr(), self.running.data_ptr(), index)

    def apply(self, cols: slice) -> None:
        """The chain's elementwise steps on the block ``cols``, in place."""
        x = self.x
        _check(x)
        m, n = x.shape
        c0, width = _span(x, cols)
        _launch("epilogue_normalize", x.device, x.data_ptr(), m, n, c0, width,
                int(self.pre), int(self.post), _ptr(self.mean), _ptr(self.std),
                _ptr(self.running[-1:], self.post))


class NormalizePlain(Normalize):
    """``Normalize``'s plain PyTorch twin, on any device: the block's column
    moments about row 0 in float64, the statistics as the kernel rounds them,
    the exact minimum of the standardized block, and the chain's steps."""

    def _y(self, block: torch.Tensor) -> torch.Tensor:
        return accurate_log2(block + 1.0) if self.pre else block

    def _z(self, y: torch.Tensor, cols: slice) -> torch.Tensor:
        if self.mean is not None:
            y = y - self.mean[cols]
        if self.std is not None:
            y = y / self.std[cols]
        return y

    def stats(self, index: int, cols: slice) -> None:
        y = self._y(self.x[:, cols])
        if COMPUTED in (self.mean_mode, self.std_mode):
            pivot = y[0]
            d = y.double() - pivot.double()
            mean, std = stats_from_moments(d.sum(dim=0), (d * d).sum(dim=0), y.shape[0], pivot)
            if self.mean_mode == COMPUTED:
                self.mean[cols] = mean
            if self.std_mode == COMPUTED:
                self.std[cols] = std
        if self.post:
            low = self._z(y, cols).min()  # NaN carries
            self.running[index] = low if index == 0 else _nan_min(self.running[index - 1], low)

    def apply(self, cols: slice) -> None:
        block = self.x[:, cols]
        if self.pre:
            accurate_log2(block + 1.0, out=block)
        if self.mean is not None:
            block.sub_(self.mean[cols])
        if self.std is not None:
            block.div_(self.std[cols])
        if self.post:
            accurate_log2(block + self.running[-1].abs() + 1.0, out=block)


def _moments_out(x: torch.Tensor):
    return tuple(torch.empty(x.shape[0], dtype=torch.float64, device=x.device) for _ in range(2))


def row_moments(x: torch.Tensor, blocks: list):
    """Each row's float64 ``(s, q)``: the sums of ``x[r] - x[r, 0]`` and of its
    square over every column, one launch a column block."""
    _check(x)
    m, n = x.shape
    s, q = _moments_out(x)
    for index, cols in enumerate(blocks):
        c0, width = _span(x, cols)
        _launch("epilogue_row_stats", x.device, x.data_ptr(), m, n, c0, width, int(index == 0),
                s.data_ptr(), q.data_ptr())
    return s, q


def row_moments_plain(x: torch.Tensor, blocks: list):
    """``row_moments``' plain twin: the same sums, block by block."""
    s, q = _moments_out(x)
    pivot = x[:, :1].double()
    for index, cols in enumerate(blocks):
        d = x[:, cols].double() - pivot
        part_s, part_q = d.sum(dim=1), (d * d).sum(dim=1)
        if index == 0:
            s.copy_(part_s)
            q.copy_(part_q)
        else:
            s.add_(part_s)
            q.add_(part_q)
    return s, q


def row_stats(x: torch.Tensor, moments) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(mean, std)`` of each row from its ``row_moments``."""
    return stats_from_moments(*moments, x.shape[1], x[:, 0])


def standardize_split(x: torch.Tensor, moments, cols: slice, hi: torch.Tensor,
                      lo: torch.Tensor):
    """The block ``cols`` of ``x``'s rows standardized by ``moments`` in float32
    and split into TF32 halves (``ops.pearson.split_tf32``) into the [m, width]
    scratch ``hi`` and ``lo``; returns ``(hi, lo)``."""
    _check(x)
    m, n = x.shape
    c0, width = _span(x, cols)
    for half in (hi, lo):
        if not (half.is_cuda and half.device == x.device and half.dtype == torch.float32
                and half.shape == (m, width) and half.is_contiguous() and _aligned(half)):
            raise ValueError(f"hi and lo must be contiguous float32 [{m}, {width}] on "
                             f"{x.device}, got {tuple(half.shape)} {half.dtype} on {half.device}")
    s, q = moments
    _launch("epilogue_standardize_split", x.device, x.data_ptr(), m, n, c0, width,
            s.data_ptr(), q.data_ptr(), hi.data_ptr(), lo.data_ptr())
    return hi, lo


def standardize_split_plain(x: torch.Tensor, moments, cols: slice, hi: torch.Tensor,
                            lo: torch.Tensor):
    """``standardize_split``'s plain twin."""
    from seekr_tpu_torch.ops.pearson import split_tf32  # ops.pearson imports this module

    mean, std = row_stats(x, moments)
    a = (x[:, cols] - mean[:, None]) / std[:, None]
    return split_tf32(a, hi, lo)

