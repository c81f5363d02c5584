"""Shared checks of the plotting and graph entry points.

Port of ``check_norm_compat`` from ``seekr_tpu/viz/style.py:93-110``; the rest of
that module (fonts, the headless backend, figure saving) needs matplotlib and
comes with the port's plotting slice.
"""

from __future__ import annotations

import numpy as np


def check_norm_compat(mean_path: str, std_path: str, k: int, what: str) -> bool:
    """k vs norm-vector length check shared by the plotting entry points.

    Implements the reference's *intended* check; upstream repeats the same
    operator-precedence bug in every module (e.g. kmer_count_barplot.py:65).
    """
    meanfile = np.load(mean_path)
    stdfile = np.load(std_path)
    if len(meanfile) != 4 ** k or len(stdfile) != 4 ** k:
        print("kmer size is not compatible with the normalization mean "
              "and/or std files.")
        print("Please make sure the normalization mean and std files are "
              "generated using the same kmer size as specified here in k.")
        print(f"No {what}. The output is None.")
        return False
    return True
