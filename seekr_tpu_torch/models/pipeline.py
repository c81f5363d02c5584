"""SeekrPipeline: encoded sequences to the all-pairs Pearson matrix on one card.

Port of ``seekr_tpu/models/pipeline.py``:

    bases [m, L] int8, lengths [m]
      -> k-mer histogram counts [m, 4^k]        (ops.count, the CUDA kernel on a card)
      -> normalize chain                        (ops.normalize)
      -> row-standardized GEMM r-matrix [m, m]  (ops.pearson)

seekr_tpu's ``m <= 4096`` optimization barrier worked around a TPU layout; the
port keeps the counts flat ``[m, 4^k]`` throughout and has no such gate.
"""

from __future__ import annotations

import torch

from seekr_tpu_torch.ops.count import count_graph
from seekr_tpu_torch.ops.count_cuda import split_hi_lo
from seekr_tpu_torch.ops.normalize import LOG2_POST, check_log2_mode, normalize_graph
from seekr_tpu_torch.ops.pearson import pearson_graph
from seekr_tpu_torch.utils.device import resolve_device
from seekr_tpu_torch.utils.profiler import span


class SeekrPipeline:
    """Fused count -> normalize -> Pearson pipeline for one device.

    Parameters
    ----------
    k : k-mer size (default 6, the reference CLI default)
    log2 : 'Log2.pre' | 'Log2.post' | 'Log2.none'
    device : where it runs; ``None`` is the first CUDA card (``"cpu"`` must be
        asked for explicitly)
    """

    def __init__(self, k: int = 6, log2: str = LOG2_POST, device=None):
        check_log2_mode(log2)
        self.k = k
        self.log2 = log2
        self.device = resolve_device(device)

    def _inputs(self, bases, lengths):
        """numpy or tensor inputs -> contiguous int8 / int32 tensors on the device."""
        b = torch.as_tensor(bases).to(device=self.device, dtype=torch.int8).contiguous()
        n = torch.as_tensor(lengths).to(device=self.device, dtype=torch.int32).contiguous()
        return b, n

    def _vector(self, v):
        # float64 .npy norm vectors are cast, as seekr_tpu does, so they do not
        # promote the chain (and the Pearson GEMM) to float64
        if v is None:
            return None
        return torch.as_tensor(v).to(device=self.device, dtype=torch.float32).reshape(-1)

    def _normalized(self, bases, lengths, mean, std):
        raw = count_graph(*self._inputs(bases, lengths), self.k)
        return normalize_graph(raw, self._vector(mean), self._vector(std), self.log2)

    def counts(self, bases, lengths, mean=None, std=None, flat=True):
        """Normalized counts and the mean/std used (flat ``[4^k]``).

        ``mean``/``std``: ``None`` computes the column statistic, a vector is
        used as given.  ``flat=False`` returns an ``[m, n_hi, n_lo]`` view.
        """
        counts, mean, std = self._normalized(bases, lengths, mean, std)
        if not flat:
            counts = counts.view(counts.shape[0], *split_hi_lo(self.k))
        return counts, mean, std

    def forward(self, bases, lengths, mean=None, std=None) -> torch.Tensor:
        """Full pipeline: encoded sequences -> [m, m] Pearson r matrix."""
        with span("pipeline.forward"):
            normalized, _, _ = self._normalized(bases, lengths, mean, std)
            return pearson_graph(normalized)
