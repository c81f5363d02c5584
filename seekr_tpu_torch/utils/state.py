"""State carried across from ``seekr_tpu``.

The system has no weights.  Its state is norm vectors (column mean/std ``[4^k]``,
written by ``seekr_norm_vectors`` or set on ``KmerCounter.mean/.std``) and count
matrices.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_state(state: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """numpy arrays from ``seekr_tpu`` -> float32 tensors on ``device``.

    Vectors are cast to float32 as ``seekr_tpu/models/pipeline.py`` does for
    float64 ``.npy`` artifacts.  A 3-D ``[m, n_hi, n_lo]`` count tensor (from
    ``count_graph(flat=False)``) is flattened to ``[m, 4^k]``: its row-major bytes
    are already the flat order.
    """
    out = {}
    for name, arr in state.items():
        # a copy: arrays fetched from jax are read-only
        t = torch.as_tensor(np.array(arr, dtype=np.float32), device=device)
        out[name] = t.reshape(t.shape[0], -1) if t.dim() == 3 else t
    return out
