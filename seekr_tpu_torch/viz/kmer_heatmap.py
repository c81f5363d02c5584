"""Heatmap (optionally hierarchically clustered) of r- or p-value matrices.

Port of ``seekr_tpu/viz/kmer_heatmap.py`` (behavioural parity with
seekr/kmer_heatmap.py:78-349): a 2/3-color LinearSegmentedColormap with the
threshold pivot, optional row and column clustering (pdist -> linkage ->
leaves_list) with inset dendrograms, a seaborn heatmap, a colorbar with the
threshold tick injected, the pdf fallback.  The pdist runs on the card above
``ops.dist``'s size threshold.  ``_linkage_or_explain`` and ``_cluster_orders``
are the compute half, callable without matplotlib or seaborn.
"""

from __future__ import annotations

import numpy as np

from seekr_tpu_torch.viz.style import (check_hex_colors, ensure_headless_backend,
                                       save_figure, setup_fonts)

DEFAULT_COLORS = ["#1b7837", "#ffffff", "#c51b7d"]


def make_cmap(color_range, thresh_value, datamin, datamax):
    """2- or 3-color colormap; the middle color pins at the threshold."""
    from matplotlib.colors import LinearSegmentedColormap

    if not check_hex_colors(color_range):
        print("color_range must be a list of valid hex colors "
              "(for example '#ffffff').")
        print("Use default color_range instead: "
              "['#1b7837', '#ffffff', '#c51b7d']")
        color_range = DEFAULT_COLORS
    if len(color_range) < 2 or len(color_range) > 3:
        print("color_range must have 2 or 3 colors. "
              "Check color_range list length.")
        print("Use default color_range instead: "
              "['#1b7837', '#ffffff', '#c51b7d']")
        color_range = DEFAULT_COLORS
    if len(color_range) == 2:
        stops = [(0, color_range[0]), (1, color_range[1])]
    else:
        # clamp the pivot into (0, 1): a threshold outside [datamin, datamax]
        # (every p-value above the default 0.05) or datamin == datamax would
        # make from_list raise; the clamped colormap keeps the colors in order
        span = datamax - datamin
        turnval = (thresh_value - datamin) / span if span else 0.5
        turnval = min(max(turnval, 1e-9), 1 - 1e-9)
        stops = [(0, color_range[0]), (turnval, color_range[1]),
                 (1, color_range[2])]
    return LinearSegmentedColormap.from_list("custom_cmap", stops)


def _linkage_or_explain(data, distmetric, linkmethod, device=None):
    """linkage(pdist(...)) with the reference's advisory error messages."""
    from scipy.cluster.hierarchy import linkage

    from seekr_tpu_torch.ops.dist import pdist_auto

    try:
        return linkage(pdist_auto(data, metric=distmetric, device=device),
                       method=linkmethod)
    except ValueError as e:
        if "Unknown Distance Metric" in str(e):
            print(f"The specified distance metric '{distmetric}' is not "
                  "supported.")
            print("Check the documentation for scipy.spatial.distance.pdist "
                  "for a list of valid metrics.")
        elif "Invalid method" in str(e):
            print(f"The specified linkage method '{linkmethod}' is not "
                  "supported.")
            print("Check the documentation for "
                  "scipy.cluster.hierarchy.linkage for a list of valid "
                  "methods.")
        raise


def _cluster_orders(data, distmetric, linkmethod, device=None):
    """(row linkage, row leaf order, column linkage, column leaf order)."""
    from scipy.cluster.hierarchy import leaves_list

    row_linkage = _linkage_or_explain(data, distmetric, linkmethod, device)
    col_linkage = _linkage_or_explain(data.T, distmetric, linkmethod, device)
    return row_linkage, leaves_list(row_linkage), col_linkage, leaves_list(col_linkage)


def _add_colorbar(ax_heatmap, ax_host, thresh_value, cbar_font_size):
    import matplotlib.pyplot as plt

    cbar = plt.colorbar(ax_heatmap.collections[0], ax=ax_host, fraction=1,
                        pad=0, anchor=(0, 0), aspect=30)
    cbar.ax.tick_params(labelsize=cbar_font_size)
    current_ticks = cbar.get_ticks()
    if thresh_value not in current_ticks:
        cbar.set_ticks(np.sort(np.append(current_ticks, thresh_value)))
    return cbar


def _hide_axes(ax):
    ax.set_xticks([])
    ax.set_yticks([])
    for spine in ax.spines.values():
        spine.set_visible(False)


def kmer_heatmap(df, datamin, datamax, thresh_value=0.05,
                 color_range=None, cluster=True, distmetric="correlation",
                 linkmethod="complete", hmapw_ratio=0.3, hmaph_ratio=0.3,
                 x_tick_size=16, y_tick_size=16, cbar_font_size=16,
                 outputname="test_kmer_heatmap", hformat="pdf", hdpi=300,
                 device=None):
    """seekr_tpu's ``kmer_heatmap`` on a ``LabeledMatrix`` (or any object with
    ``values``, ``index`` and ``columns``), plus ``device`` for the clustering's
    pdist (``None`` = the first CUDA card)."""
    ensure_headless_backend()
    import matplotlib.pyplot as plt
    import seaborn as sns
    from matplotlib.gridspec import GridSpec
    from scipy.cluster.hierarchy import dendrogram

    if color_range is None:
        color_range = DEFAULT_COLORS
    data = np.asarray(df.values)
    xheaders = df.columns
    yheaders = df.index
    cmap = make_cmap(color_range, thresh_value, datamin, datamax)

    if hmapw_ratio <= 0:
        print("hmapw_ratio must be a positive number (>0). "
              "Use default hmapw_ratio instead: 0.3")
        hmapw_ratio = 0.3
    if hmaph_ratio <= 0:
        print("hmaph_ratio must be a positive number (>0). "
              "Use default hmaph_ratio instead: 0.3")
        hmaph_ratio = 0.3
    fx = round(len(xheaders) * hmapw_ratio)
    fy = round(len(yheaders) * hmaph_ratio)

    if not cluster:
        print("cluster is set to False. Only heatmap will be plotted "
              "without dendrograms.")
        plt.figure(figsize=(fx + 3, fy + 1))
        gs = GridSpec(1, 2, width_ratios=[fx + 1, 2])
        ax_main = plt.subplot(gs[0])
        setup_fonts()
        ax_heatmap = sns.heatmap(data, cmap=cmap, vmin=datamin, vmax=datamax,
                                 yticklabels=np.array(yheaders),
                                 xticklabels=np.array(xheaders),
                                 cbar=False, ax=ax_main)
        ax_heatmap.yaxis.set_ticks_position("left")
        ax_heatmap.tick_params(axis="y", rotation=0, labelsize=y_tick_size)
        ax_heatmap.tick_params(axis="x", rotation=90, labelsize=x_tick_size)
        for spine in ax_main.spines.values():
            spine.set_visible(False)
        ax_cbar = plt.subplot(gs[1])
        _add_colorbar(ax_heatmap, ax_cbar, thresh_value, cbar_font_size)
        ax_cbar.set_zorder(-1)
        _hide_axes(ax_cbar)
        save_figure(outputname, hformat, hdpi)
        plt.close("all")
        return

    row_linkage, row_order, col_linkage, col_order = _cluster_orders(
        data, distmetric, linkmethod, device)
    data_clustered = data[row_order, :][:, col_order]

    plt.figure(figsize=(fx + 3, fy + 1))
    gs = GridSpec(1, 2, width_ratios=[fx + 1, 2])
    setup_fonts()

    ax_main = plt.subplot(gs[0])
    ax_row_dendrogram = ax_main.inset_axes([0.05, 0.1, 0.2, 0.65])
    dendrogram(row_linkage, orientation="left", ax=ax_row_dendrogram,
               color_threshold=0)
    ax_row_dendrogram.set_axis_off()
    ax_col_dendrogram = ax_main.inset_axes([0.26, 0.76, 0.65, 0.2])
    dendrogram(col_linkage, ax=ax_col_dendrogram, color_threshold=0)
    ax_col_dendrogram.set_axis_off()

    ax_heatmap = ax_main.inset_axes([0.26, 0.1, 0.65, 0.65])
    sns.heatmap(data_clustered, cmap=cmap, vmin=datamin, vmax=datamax,
                yticklabels=np.array(yheaders)[row_order],
                xticklabels=np.array(xheaders)[col_order], cbar=False,
                ax=ax_heatmap)
    ax_heatmap.yaxis.set_ticks_position("right")
    ax_heatmap.tick_params(axis="y", rotation=0, labelsize=y_tick_size)
    ax_heatmap.tick_params(axis="x", rotation=90, labelsize=x_tick_size)
    _hide_axes(ax_main)

    ax_cbar_main = plt.subplot(gs[1])
    ax_cbar = ax_cbar_main.inset_axes([0.3, 0.1, 1, 0.65])
    _add_colorbar(ax_heatmap, ax_cbar, thresh_value, cbar_font_size)
    ax_cbar_main.set_zorder(-1)
    _hide_axes(ax_cbar_main)
    _hide_axes(ax_cbar)
    save_figure(outputname, hformat, hdpi)
    plt.close("all")
