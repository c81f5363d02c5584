"""Reference-layout alias: `seekr.kmer_msd_barplot` -> seekr_tpu_torch (see seekr/kmer_msd_barplot.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.viz.kmer_msd_barplot import kmer_msd_barplot

__all__ = ['kmer_msd_barplot']


# The package root also exports `kmer_msd_barplot` as a function; importing this module
# rebinds that attribute to the module object.  A callable module keeps both
# idioms working in one process: `seekr_tpu_torch.kmer_msd_barplot(...)` and
# `from seekr_tpu_torch.kmer_msd_barplot import kmer_msd_barplot`.
import sys as _sys  # noqa: E402


class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(kmer_msd_barplot)


_sys.modules[__name__].__class__ = _CallableModule
