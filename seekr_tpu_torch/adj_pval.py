"""Reference-layout alias: `seekr.adj_pval` -> seekr_tpu_torch (see seekr/adj_pval.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.stats.adj_pval import adj_pval, is_symmetric

__all__ = ['adj_pval', 'is_symmetric']


# The package root also exports `adj_pval` as a function; importing this module
# rebinds that attribute to the module object.  A callable module keeps both
# idioms working in one process: `seekr_tpu_torch.adj_pval(...)` and
# `from seekr_tpu_torch.adj_pval import adj_pval`.
import sys as _sys  # noqa: E402


class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(adj_pval)


_sys.modules[__name__].__class__ = _CallableModule
