"""Pairwise-distance vectors for the clustering paths, as a Gram product on the card.

Port of ``seekr_tpu/ops/dist.py``.  The reference clusters heatmaps and
dendrograms with ``scipy.spatial.distance.pdist`` (seekr/kmer_heatmap.py:195,212,
kmer_dendrogram.py:100,119): O(rows^2 * cols) on one CPU core, hours at a
GENCODE-scale 13k x 13k matrix, while the same arithmetic is one float32 Gram
product on the card.  The GEMM-able scipy metrics:

  * ``correlation``  1 - <x-x̄, y-ȳ> / (|x-x̄| |y-ȳ|)  (reference default)
  * ``cosine``       1 - <x, y> / (|x| |y|)
  * ``euclidean``    sqrt(|x|^2 + |y|^2 - 2<x,y>)
  * ``sqeuclidean``  |x|^2 + |y|^2 - 2<x,y>

Values agree with scipy's float64 within ~1e-5, so merges at near-tie heights
may order differently.  scipy's exact pdist is the contract below
``_DEVICE_MIN_WORK`` flops and for every other metric;
``SEEKR_TPU_PDIST={device,scipy}`` forces either side.  Unlike seekr_tpu's
``pdist_auto``, a failed device pdist raises: at the sizes routed to the card,
scipy would take hours on one core.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from seekr_tpu_torch.ops.precision import pearson_precision
from seekr_tpu_torch.utils.adj import triu_values
from seekr_tpu_torch.utils.device import resolve_device

#: metrics with a GEMM formulation (everything else always goes to scipy)
DEVICE_METRICS = ("correlation", "cosine", "euclidean", "sqeuclidean")

# the card by default only when scipy's rows^2 * cols crosses ~10^10 flops
# (minutes on one core)
_DEVICE_MIN_WORK = float(2 ** 33)


def use_device_pdist(rows: int, cols: int, metric: str) -> bool:
    """Routing decision for one pdist call (shape + metric + env)."""
    if str(metric) not in DEVICE_METRICS:
        return False
    forced = os.environ.get("SEEKR_TPU_PDIST", "").lower()
    if forced == "scipy":
        return False
    if forced == "device":
        return True
    return float(rows) * float(rows) * float(cols) >= _DEVICE_MIN_WORK


def distance_matrix(x: torch.Tensor, metric: str) -> torch.Tensor:
    """[m, m] float32 distance matrix of the rows of ``x`` for one of
    DEVICE_METRICS: the Gram product in full float32 and its epilogue."""
    x = x.to(torch.float32)
    if metric == "correlation":
        x = x - x.mean(dim=1, keepdim=True)
    if metric in ("correlation", "cosine"):
        x = x / torch.sqrt((x * x).sum(dim=1, keepdim=True))  # a zero row: NaN
        with pearson_precision():
            g = x @ x.T
        return 1.0 - g
    with pearson_precision():
        g = x @ x.T
    sq = torch.diagonal(g)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * g).clamp_(min=0.0)  # the GEMM's tiny negatives
    if metric == "sqeuclidean":
        return d2
    return d2.sqrt_()


def pdist_device(data, metric: str = "correlation", device=None) -> np.ndarray:
    """scipy-compatible condensed distance vector, computed on ``device``.

    Returns float64 [m*(m-1)/2] in scipy's row-major strict-upper-triangle
    order; ``device=None`` is the first CUDA card.  Raises ValueError for
    metrics outside DEVICE_METRICS.
    """
    metric = str(metric)
    if metric not in DEVICE_METRICS:
        raise ValueError(f"metric {metric!r} has no device formulation; "
                         f"supported: {DEVICE_METRICS}")
    dev = resolve_device(device)
    arr = np.ascontiguousarray(data, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError("pdist_device needs a 2-D array")
    full = distance_matrix(torch.from_numpy(arr).to(dev), metric).cpu().numpy()
    return triu_values(full.astype(np.float64))


def pdist_auto(data, metric: str = "correlation", device=None) -> np.ndarray:
    """pdist on the card when ``use_device_pdist`` says so, else scipy's exact
    float64 pdist.  ``device`` is resolved first, so ``None`` without CUDA raises
    whatever the size; a failure of the device path raises too."""
    dev = resolve_device(device)
    arr = np.asarray(data)
    if arr.ndim == 2 and use_device_pdist(arr.shape[0], arr.shape[1], metric):
        return pdist_device(arr, metric=metric, device=dev)
    from scipy.spatial.distance import pdist

    return pdist(arr, metric=metric)
