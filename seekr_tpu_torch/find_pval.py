"""Reference-layout alias: `seekr.find_pval` -> seekr_tpu_torch (see seekr/find_pval.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.stats.find_pval import find_pval, is_float_type, check_tuple_format, check_main_list

__all__ = ['check_main_list', 'check_tuple_format', 'find_pval', 'is_float_type']


# The package root also exports `find_pval` as a function; importing this module
# rebinds that attribute to the module object.  A callable module keeps both
# idioms working in one process: `seekr_tpu_torch.find_pval(...)` and
# `from seekr_tpu_torch.find_pval import find_pval`.
import sys as _sys  # noqa: E402


class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(find_pval)


_sys.modules[__name__].__class__ = _CallableModule
