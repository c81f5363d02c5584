"""Reference-layout alias: `seekr.pearson` -> seekr_tpu_torch (see seekr/pearson.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.models.pearson import pearson

__all__ = ['pearson']


# The package root also exports `pearson` as a function; importing this module
# rebinds that attribute to the module object.  A callable module keeps both
# idioms working in one process: `seekr_tpu_torch.pearson(...)` and
# `from seekr_tpu_torch.pearson import pearson`.
import sys as _sys  # noqa: E402


class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(pearson)


_sys.modules[__name__].__class__ = _CallableModule
