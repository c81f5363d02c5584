"""Reference-layout alias: `seekr.kmer_comp_textplot` -> seekr_tpu_torch (see seekr/kmer_comp_textplot.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.viz.textplot import kmer_comp_textplot, find_word_coordinates, ass_color

__all__ = ['ass_color', 'find_word_coordinates', 'kmer_comp_textplot']


# The package root also exports `kmer_comp_textplot` as a function; importing this module
# rebinds that attribute to the module object.  A callable module keeps both
# idioms working in one process: `seekr_tpu_torch.kmer_comp_textplot(...)` and
# `from seekr_tpu_torch.kmer_comp_textplot import kmer_comp_textplot`.
import sys as _sys  # noqa: E402


class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(kmer_comp_textplot)


_sys.modules[__name__].__class__ = _CallableModule
