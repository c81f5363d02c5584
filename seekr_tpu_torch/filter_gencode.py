"""Reference-layout alias: `seekr.filter_gencode` -> seekr_tpu_torch (see seekr/filter_gencode.py).

Lets a reference user's imports keep working after `s/seekr/seekr_tpu_torch/`:
the implementation lives at the canonical path below; nothing is defined here.
"""

from seekr_tpu_torch.data.filter_gencode import filter_gencode, get_transcript_id_with_ensembl_canonical, get_transcript_id_with_isoform

__all__ = ['filter_gencode', 'get_transcript_id_with_ensembl_canonical', 'get_transcript_id_with_isoform']


# The package root also exports `filter_gencode` as a function; importing this module
# rebinds that attribute to the module object.  A callable module keeps both
# idioms working in one process: `seekr_tpu_torch.filter_gencode(...)` and
# `from seekr_tpu_torch.filter_gencode import filter_gencode`.
import sys as _sys  # noqa: E402


class _CallableModule(_sys.modules[__name__].__class__):
    __call__ = staticmethod(filter_gencode)


_sys.modules[__name__].__class__ = _CallableModule
