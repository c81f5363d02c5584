"""Shared plotting style, figure saving and checks of the plotting entry points.

Port of ``seekr_tpu/viz/style.py``.  The reference repeats font registration and
the save-format fallback in every plotting module (e.g.
seekr/kmer_heatmap.py:126-135,185-190); here they live once.  Font lookup order,
in the port's own data directory (``seekr_tpu_torch/data``):

  1. ``arial.ttf`` -- drop Arial here for the reference's exact glyphs (not
     shipped: Arial is not redistributable),
  2. the bundled ``default_plot_font.ttf`` (DejaVu Sans, free license in
     ``data/LICENSE_DEJAVU``),
  3. matplotlib's default sans-serif.

PDF fonttype 42 (editable text in Illustrator) is always set.  matplotlib is
imported inside the functions that draw: the card's machine has none.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.realpath(__file__)), "..", "data")
_FONT_PATHS = (os.path.join(_DATA_DIR, "arial.ttf"),
               os.path.join(_DATA_DIR, "default_plot_font.ttf"))


def is_hex_color(s) -> bool:
    """'#rrggbb' check (seekr/kmer_heatmap.py:72-73)."""
    return isinstance(s, str) and re.fullmatch(r"#[0-9a-fA-F]{6}", s) is not None


def check_hex_colors(lst) -> bool:
    return all(is_hex_color(color) for color in lst)


def ensure_headless_backend():
    """Pin the Agg backend only when pyplot has not been imported yet.

    Library code must not switch backends mid-session: ``matplotlib.use`` after
    pyplot is up closes all of the caller's open figures.  A command-line
    process (pyplot not imported yet) still gets Agg before its first pyplot
    import.
    """
    if "matplotlib.pyplot" not in sys.modules:
        import matplotlib

        matplotlib.use("Agg")


def setup_fonts():
    """Register the bundled font (if any) and set editable-pdf fonttype."""
    import matplotlib as mpl
    import matplotlib.pyplot as plt

    for font_path in map(os.path.normpath, _FONT_PATHS):
        if os.path.exists(font_path):
            import matplotlib.font_manager as font_manager

            font_manager.fontManager.addfont(font_path)
            prop = font_manager.FontProperties(fname=font_path)
            plt.rcParams["font.family"] = prop.get_name()
            break
    else:
        plt.rcParams["font.family"] = "sans-serif"
    mpl.rcParams["pdf.fonttype"] = 42


def save_figure(outputname: str, fmt: str, dpi: int):
    """Save the current figure; an unsupported format falls back to pdf with the
    reference's message (seekr/kmer_heatmap.py:185-190)."""
    import matplotlib.pyplot as plt

    formatlist = list(plt.gcf().canvas.get_supported_filetypes())
    if fmt in formatlist:
        plt.savefig(f"{outputname}.{fmt}", format=fmt, dpi=dpi, bbox_inches="tight")
    else:
        print("plotformat not supported. use default 'pdf' now. other common "
              "formats are: 'png', 'jpg', 'svg', 'eps', 'tif', 'tiff', 'ps', "
              "'webp'")
        plt.savefig(f"{outputname}.pdf", format="pdf", dpi=dpi, bbox_inches="tight")


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
