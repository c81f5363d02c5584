"""Reference-layout alias: `seekr.kmer_heatmap` -> seekr_tpu_torch (see seekr/kmer_heatmap.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.viz.kmer_heatmap import kmer_heatmap
from seekr_tpu_torch.viz.style import is_hex_color, check_hex_colors

__all__ = ['check_hex_colors', 'is_hex_color', 'kmer_heatmap']


# The package root also exports `kmer_heatmap` as a function; importing this module
# rebinds that attribute to the module object.  A callable module keeps both
# idioms working in one process: `seekr_tpu_torch.kmer_heatmap(...)` and
# `from seekr_tpu_torch.kmer_heatmap import kmer_heatmap`.
import sys as _sys  # noqa: E402


class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(kmer_heatmap)


_sys.modules[__name__].__class__ = _CallableModule
