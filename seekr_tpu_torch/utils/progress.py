"""Notebook-aware progress bars (the reference's seekr/my_tqdm.py:17-32).

Port of ``seekr_tpu/utils/progress.py``.  tqdm is imported only when a bar is
asked for: the port does not need it otherwise.
"""

import sys


def _is_kernel() -> bool:
    if "IPython" not in sys.modules:
        return False
    from IPython import get_ipython

    return getattr(get_ipython(), "kernel", None) is not None


def my_tqdm():
    if _is_kernel():
        from tqdm.notebook import tqdm as tqdm_notebook

        return tqdm_notebook
    from tqdm import tqdm

    return tqdm


def my_trange():
    if _is_kernel():
        from tqdm.notebook import trange as tnrange

        return tnrange
    from tqdm import trange

    return trange
