"""seekr_tpu_torch -- the PyTorch/CUDA port of seekr_tpu for NVIDIA Hopper.

The same public API as ``seekr_tpu`` for the count -> normalize -> Pearson
path, run with PyTorch on one CUDA card:

  * FASTA reading and 2-bit encoding with length buckets (``io``)
  * the k-mer histogram as a hand-written CUDA kernel (``ops.count_cuda``,
    sources in ``csrc/``), the normalize chain and the float32 Pearson GEMM
    (``ops``)
  * ``KmerCounter``/``BasicCounter``, ``pearson`` and ``SeekrPipeline``
    (``models``)

Entry points take ``device=None``, which means the first CUDA card; without one
they raise unless ``device="cpu"`` is asked for (``utils.device``).  The package
imports neither jax nor seekr_tpu.
"""

from seekr_tpu_torch.__version__ import __version__, __title__, __description__, __license__

# Exports resolve lazily (PEP 562), so importing the package root does not
# import torch.
_LAZY_EXPORTS = {
    "KmerCounter": ("seekr_tpu_torch.models.counter", "KmerCounter"),
    "BasicCounter": ("seekr_tpu_torch.models.counter", "BasicCounter"),
    "pearson": ("seekr_tpu_torch.models.pearson", "pearson"),
    "SeekrPipeline": ("seekr_tpu_torch.models.pipeline", "SeekrPipeline"),
}

__all__ = ["KmerCounter", "BasicCounter", "pearson", "SeekrPipeline", "__version__"]


def __getattr__(name):
    if name in _LAZY_EXPORTS:
        import importlib

        mod, attr = _LAZY_EXPORTS[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'seekr_tpu_torch' has no attribute {name!r}")
