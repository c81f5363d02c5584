"""Character-level sequence text plots with motif highlighting.

Port of ``seekr_tpu/viz/textplot.py`` (behavioural parity with
seekr/kmer_comp_textplot.py:53-184 and kmer_indi_textplot.py:81-179): sequences
rendered character by character in ``wraplen`` columns, up to 10 motif words
highlighted with colored blocks (overlaps take the first matching word's
color), a 1-based position ruler, and the same default quasi-rainbow palette.
The word coordinates (``find_word_coordinates``, ``_match_info``) are host
work, callable without matplotlib; the FASTA is read by the port's
``io.fasta.Reader``.
"""

from __future__ import annotations

import numpy as np

from seekr_tpu_torch.io.fasta import Reader
from seekr_tpu_torch.viz.style import ensure_headless_backend, save_figure, setup_fonts

DEFAULT_COLOR_VEC = [
    "#d62728", "#e377c2", "#ff7f0e", "#bcbd22", "#2ca02c",
    "#17becf", "#1f77b4", "#9467bd", "#8c564b", "#7f7f7f",
]
_DEFAULT_COLOR_MSG = ("default color order: red, pink, orange, olive, green, "
                      "cyan, blue, purple, brown, grey")


def find_word_coordinates(seq, inputword):
    """Unique 0-based positions covered by occurrences of ``inputword``.

    Same output as the reference loop (kmer_comp_textplot.py:53-68) but via
    str.find instead of slicing every window.
    """
    coords = set()
    start = seq.find(inputword)
    while start != -1:
        coords.update(range(start, start + len(inputword)))
        start = seq.find(inputword, start + 1)
    return np.array(sorted(coords), dtype=np.int64)


def ass_color(coord, matched_seq, color_vec):
    """First-word-wins color assignment (kmer_comp_textplot.py:71-76)."""
    for n in range(len(matched_seq)):
        if coord in matched_seq[n]:
            return color_vec[n]
    return None


def _resolve_words_colors(seq_words, color_vec):
    words = list(seq_words)
    if len(words) > 10:
        print("length of words list exceeds 10, plotting the first 10 only")
        words = words[:10]
    if isinstance(color_vec, str) and color_vec == "default":
        color_vec = list(DEFAULT_COLOR_VEC)
        print(_DEFAULT_COLOR_MSG)
    elif len(color_vec) != len(words):
        print("the length of color vector is not the same as the length of "
              "the words list, use default color now")
        print(_DEFAULT_COLOR_MSG)
        color_vec = list(DEFAULT_COLOR_VEC)
    return words, color_vec


def _match_info(seq, words):
    matched = [find_word_coordinates(seq, word) for word in words]
    flat = set()
    for coords in matched:
        flat.update(int(c) for c in coords)
    return matched, flat


def _draw_seq_line(ax, line_chars, line_idx, row_offset, y_base, matched,
                   matched_flat, color_vec, wraplen, char_spacing,
                   rect_height, seqfontsize, text_color):
    """One wrapped line of one sequence: color blocks + glyphs."""
    from matplotlib.patches import Rectangle

    for j, ch in enumerate(line_chars):
        pos = line_idx * wraplen + j
        color = (ass_color(pos, matched, color_vec)
                 if pos in matched_flat else "none")
        y = y_base - row_offset
        rect = Rectangle((j * char_spacing - char_spacing / 2,
                          y - rect_height / 2),
                         char_spacing, rect_height, color=color, linewidth=0)
        rect.set_clip_on(False)
        ax.add_patch(rect)
        weight = "bold" if pos in matched_flat else "normal"
        ax.text(j * char_spacing, y, ch, fontsize=seqfontsize,
                color=text_color, ha="center", va="center", weight=weight)


def kmer_comp_textplot(seq1file, seq2file, words, color_vec="default",
                       wraplen=60, char_spacing=1.0, line_spacing=0.5,
                       seqfontsize=28, numfontsize=18, colorblockh=0.5,
                       outputname="comp_textplot", plotformat="pdf",
                       plotdpi=300):
    """Two sequences interleaved line-by-line with shared motif colors."""
    ensure_headless_backend()
    import matplotlib.pyplot as plt

    seq1 = Reader(seq1file).get_seqs()[0]
    seq2 = Reader(seq2file).get_seqs()[0]

    words, color_vec = _resolve_words_colors(words, color_vec)
    matched1, flat1 = _match_info(seq1, words)
    matched2, flat2 = _match_info(seq2, words)

    wrapped1 = [seq1[i:i + wraplen] for i in range(0, len(seq1), wraplen)]
    wrapped2 = [seq2[i:i + wraplen] for i in range(0, len(seq2), wraplen)]
    total_lines = max(len(wrapped1), len(wrapped2))
    row_height = 1 + 2 * line_spacing

    fig, ax = plt.subplots(
        figsize=(wraplen * char_spacing, total_lines * row_height))
    ax.set_xlim([0, wraplen * char_spacing])
    ax.set_ylim([0, total_lines * row_height])
    setup_fonts()
    ax.axis("off")

    for i in range(total_lines):
        y_base = total_lines * row_height - i * row_height
        if i < len(wrapped1):
            _draw_seq_line(ax, wrapped1[i], i, 0.0, y_base, matched1, flat1,
                           color_vec, wraplen, char_spacing,
                           colorblockh, seqfontsize, "#000000")
        if i < len(wrapped2):
            _draw_seq_line(ax, wrapped2[i], i, line_spacing, y_base, matched2,
                           flat2, color_vec, wraplen, char_spacing,
                           colorblockh, seqfontsize, "#838383")
        for j in range(wraplen):
            if i * wraplen + j < max(len(seq1), len(seq2)):
                ax.text(j * char_spacing, y_base - line_spacing * 2,
                        str(i * wraplen + j + 1), fontsize=numfontsize,
                        ha="center", va="center")

    save_figure(outputname, plotformat, plotdpi)
    plt.close("all")


def kmer_indi_textplot(seqfile, words, color_vec="default", wraplen=60,
                       char_spacing=1.0, line_spacing=0.5, seqfontsize=28,
                       numfontsize=18, colorblockh=0.5, outputpath="",
                       plotformat="pdf", plotdpi=300):
    """One plot per sequence; plot name = header up to the first '|'."""
    ensure_headless_backend()
    import matplotlib.pyplot as plt

    reader = Reader(seqfile)
    seqs = reader.get_seqs()
    headers = [h[1:] for h in reader.get_headers()]  # cached, no re-parse
    plotnames = [header.split("|")[0] for header in headers]

    # words/colors are sequence-independent: resolve ONCE so the
    # truncation/default-color advisories print once, not per sequence
    seq_words, seq_colors = _resolve_words_colors(words, color_vec)
    for seq, plotname in zip(seqs, plotnames):
        matched, flat = _match_info(seq, seq_words)

        wrapped = [seq[i:i + wraplen] for i in range(0, len(seq), wraplen)]
        total_lines = len(wrapped)
        row_height = 1 + line_spacing

        fig, ax = plt.subplots(
            figsize=(wraplen * char_spacing, total_lines * row_height))
        ax.set_xlim([0, wraplen * char_spacing])
        ax.set_ylim([0, total_lines * row_height])
        setup_fonts()
        ax.axis("off")

        for i in range(total_lines):
            y_base = total_lines * row_height - i * row_height
            _draw_seq_line(ax, wrapped[i], i, 0.0, y_base, matched, flat,
                           seq_colors, wraplen, char_spacing,
                           colorblockh, seqfontsize, "#000000")
            for j in range(wraplen):
                if i * wraplen + j < len(seq):
                    ax.text(j * char_spacing, y_base - line_spacing,
                            str(i * wraplen + j + 1), fontsize=numfontsize,
                            ha="center", va="center")

        save_figure(f"{outputpath}{plotname}", plotformat, plotdpi)
        plt.close("all")
