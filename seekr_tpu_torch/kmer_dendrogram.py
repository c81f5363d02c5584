"""Reference-layout alias: `seekr.kmer_dendrogram` -> seekr_tpu_torch (see seekr/kmer_dendrogram.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.viz.kmer_dendrogram import kmer_dendrogram

__all__ = ['kmer_dendrogram']


# The package root also exports `kmer_dendrogram` as a function; importing this module
# rebinds that attribute to the module object.  A callable module keeps both
# idioms working in one process: `seekr_tpu_torch.kmer_dendrogram(...)` and
# `from seekr_tpu_torch.kmer_dendrogram import kmer_dendrogram`.
import sys as _sys  # noqa: E402


class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(kmer_dendrogram)


_sys.modules[__name__].__class__ = _CallableModule
