"""Reference-layout alias: `seekr.kmer_leiden` -> seekr_tpu_torch (see seekr/kmer_leiden.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.graph.kmer_leiden import kmer_leiden

__all__ = ['kmer_leiden']


# The package root also exports `kmer_leiden` as a function; importing this module
# rebinds that attribute to the module object.  A callable module keeps both
# idioms working in one process: `seekr_tpu_torch.kmer_leiden(...)` and
# `from seekr_tpu_torch.kmer_leiden import kmer_leiden`.
import sys as _sys  # noqa: E402


class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(kmer_leiden)


_sys.modules[__name__].__class__ = _CallableModule
