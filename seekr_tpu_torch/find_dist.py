"""Reference-layout alias: `seekr.find_dist` -> seekr_tpu_torch (see seekr/find_dist.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.stats.find_dist import find_dist

__all__ = ['find_dist']


# The package root also exports `find_dist` as a function; importing this module
# rebinds that attribute to the module object.  A callable module keeps both
# idioms working in one process: `seekr_tpu_torch.find_dist(...)` and
# `from seekr_tpu_torch.find_dist import find_dist`.
import sys as _sys  # noqa: E402


class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(find_dist)


_sys.modules[__name__].__class__ = _CallableModule
