"""The port's plots (``viz``) against seekr_tpu's, on the CPU.

Pixels say little (fonts, backends), so, as ``tests/test_viz_differential.py``
does against the reference, these tests capture what each package hands to the
shared drawing stack and compare that: the matrix and tick labels given to
``seaborn.heatmap``, the linkage and labels given to scipy's ``dendrogram``, the
long-form columns given to ``seaborn.barplot``, the rectangles and glyphs of the
textplots, the histogram of ``visualize_distro``, and every printed advisory.
Figures are rendered as 72 dpi PNGs (PDFs carry a creation date).

Tolerances: heatmap matrices rtol 1e-12 (the values are pairwise distinct, so
equal matrices mean equal leaf orders); linkage rtol 1e-9; barplot values 1e-4
(the port's counts against seekr_tpu's, rtol 1e-4 / atol 1e-5) with the word
order equal; everything else equal.
"""

import importlib
import os
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pandas as pd
import pytest

from seekr_tpu_torch.io.fast_csv import LabeledMatrix
from seekr_tpu_torch.io.fasta import write_fasta

CPU = "cpu"
# the modules, not the functions of the same name that viz/__init__ exports
jax_heatmap = importlib.import_module("seekr_tpu.viz.kmer_heatmap")
heatmap = importlib.import_module("seekr_tpu_torch.viz.kmer_heatmap")
jax_textplot = importlib.import_module("seekr_tpu.viz.textplot")
textplot = importlib.import_module("seekr_tpu_torch.viz.textplot")
jax_distro = importlib.import_module("seekr_tpu.viz.visualize_distro")
distro = importlib.import_module("seekr_tpu_torch.viz.visualize_distro")


@pytest.fixture(scope="module")
def sim():
    x = np.random.default_rng(5).normal(size=(9, 40))
    values = np.corrcoef(x)
    names = [f"seq{i}" for i in range(9)]
    return LabeledMatrix(values, names, names), pd.DataFrame(values, names, names)


@pytest.fixture(scope="module")
def norm_fixture(tmp_path_factory):
    """ldseq.fa (21 sequences: the first-10 message) and its k=2 vectors."""
    from seekr_tpu_torch.models.counter import KmerCounter

    root = tmp_path_factory.mktemp("norm")
    fa = str(Path(__file__).parent / "fixtures" / "ldseq.fa")
    raw = KmerCounter(fa, k=2, mean=False, std=False, silent=True, device=CPU).get_counts()
    np.save(root / "mean.npy", raw.mean(axis=0))
    np.save(root / "std.npy", raw.std(axis=0))
    return fa, str(root / "mean.npy"), str(root / "std.npy")


def capture(monkeypatch, module, name, keys):
    """Record the data argument and ``keys`` of every call of module.name."""
    calls = []
    original = getattr(module, name)

    def recorder(*args, **kwargs):
        data = kwargs.get("data", args[0] if args else None)
        calls.append({"data": data, **{k: kwargs.get(k) for k in keys}})
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, recorder)
    return calls


def run_both(capsys, ours, theirs):
    """Run the port's call, then seekr_tpu's; return what each printed."""
    ours()
    printed = capsys.readouterr().out
    theirs()
    return printed, capsys.readouterr().out


# -- heatmap -----------------------------------------------------------------

@pytest.mark.parametrize("cluster,ratios", [(True, (0.3, 0.3)), (False, (0, -1))],
                         ids=["clustered", "flat-with-advisories"])
def test_heatmap_matrix_and_labels_match(sim, tmp_path, monkeypatch, capsys, cluster,
                                         ratios):
    import seaborn

    labeled, frame = sim
    calls = capture(monkeypatch, seaborn, "heatmap",
                    ("vmin", "vmax", "xticklabels", "yticklabels"))
    kw = dict(cluster=cluster, hmapw_ratio=ratios[0], hmaph_ratio=ratios[1],
              hformat="png", hdpi=72)
    ours, theirs = run_both(
        capsys,
        lambda: heatmap.kmer_heatmap(labeled, -1, 1, outputname=str(tmp_path / "t"),
                                     device=CPU, **kw),
        lambda: jax_heatmap.kmer_heatmap(frame, -1, 1, outputname=str(tmp_path / "j"),
                                         **kw))
    assert ours == theirs
    assert (tmp_path / "t.png").stat().st_size > 0
    got, want = calls
    np.testing.assert_allclose(np.asarray(got["data"]), np.asarray(want["data"]),
                               rtol=1e-12)
    for key in ("xticklabels", "yticklabels"):
        assert list(got[key]) == list(want[key])
    assert (got["vmin"], got["vmax"]) == (want["vmin"], want["vmax"])


def test_heatmap_format_fallback_and_bad_metric(sim, tmp_path, capsys):
    labeled, frame = sim
    ours, theirs = run_both(
        capsys,
        lambda: heatmap.kmer_heatmap(labeled, -1, 1, cluster=False, hformat="nope",
                                     outputname=str(tmp_path / "t"), device=CPU),
        lambda: jax_heatmap.kmer_heatmap(frame, -1, 1, cluster=False, hformat="nope",
                                         outputname=str(tmp_path / "j")))
    assert ours == theirs and "plotformat not supported" in ours
    assert (tmp_path / "t.pdf").stat().st_size > 0
    for module, data, kw in ((heatmap, labeled, {"device": CPU}), (jax_heatmap, frame, {})):
        with pytest.raises(ValueError):
            module.kmer_heatmap(data, -1, 1, distmetric="nope",
                                outputname=str(tmp_path / "x"), **kw)
    printed = capsys.readouterr().out.split("\n")
    assert printed[:2] == printed[2:4] and "is not supported" in printed[0]


@pytest.mark.parametrize("colors,thresh,dmin,dmax", [
    (["#1b7837", "#ffffff", "#c51b7d"], 0.05, 0, 1),
    (["#1b7837", "#ffffff", "#c51b7d"], 0.5, -1, 1),
    (["#1b7837", "#ffffff", "#c51b7d"], 3.0, -1, 1),   # threshold above the range
    (["#1b7837", "#ffffff", "#c51b7d"], -2.0, 0, 1),   # and below it
    (["#1b7837", "#ffffff", "#c51b7d"], 0.2, 1, 1),    # an empty range
    (["#000000", "#ff0000"], 0.2, 0, 1),
    (["#000000", "red", "#ff0000"], 0.2, 0, 1),       # a bad hex color
    (["#000000", "#111111", "#222222", "#333333"], 0.2, 0, 1),  # four colors
])
def test_make_cmap_stops(capsys, colors, thresh, dmin, dmax):
    got = heatmap.make_cmap(colors, thresh, dmin, dmax)
    printed = capsys.readouterr().out
    want = jax_heatmap.make_cmap(colors, thresh, dmin, dmax)
    assert printed == capsys.readouterr().out
    assert got._segmentdata.keys() == want._segmentdata.keys()
    for channel in got._segmentdata:
        np.testing.assert_array_equal(np.asarray(got._segmentdata[channel]),
                                      np.asarray(want._segmentdata[channel]))


# -- dendrogram --------------------------------------------------------------

@pytest.mark.parametrize("direction,wd_ratio,plot_ht", [
    ("row", 0.5, 8), ("column", -1, 0), ("diag", 0.5, 8)])
def test_dendrogram_linkage_and_labels_match(sim, tmp_path, monkeypatch, capsys,
                                             direction, wd_ratio, plot_ht):
    import scipy.cluster.hierarchy as sch

    from seekr_tpu.viz.kmer_dendrogram import kmer_dendrogram as jax_dendrogram
    from seekr_tpu_torch.viz.kmer_dendrogram import kmer_dendrogram

    labeled, frame = sim
    calls = capture(monkeypatch, sch, "dendrogram", ("labels",))
    kw = dict(dendro_direct=direction, wd_ratio=wd_ratio, plot_ht=plot_ht,
              pformat="png", pdpi=72)
    ours, theirs = run_both(
        capsys,
        lambda: kmer_dendrogram(labeled, outputname=str(tmp_path / "t"), device=CPU, **kw),
        lambda: jax_dendrogram(frame, outputname=str(tmp_path / "j"), **kw))
    assert ours == theirs
    if direction == "diag":
        assert calls == [] and "must be either 'row' or 'column'" in ours
        return
    got, want = calls
    np.testing.assert_allclose(got["data"], want["data"], rtol=1e-9, atol=1e-12)
    assert list(got["labels"]) == list(want["labels"])
    assert (tmp_path / "t.png").stat().st_size > 0


# -- barplots ----------------------------------------------------------------

def assert_same_rows(got, want):
    assert list(got["Sample"]) == list(want["Sample"])
    assert list(got["Kword"]) == list(want["Kword"])
    np.testing.assert_allclose(np.asarray(got["Value"], np.float64),
                               want["Value"].to_numpy(np.float64), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sortmethod,topk", [("descending", 3), ("sideways", 20)])
def test_count_barplot_rows_match(norm_fixture, tmp_path, monkeypatch, capsys,
                                  sortmethod, topk):
    import seaborn

    from seekr_tpu.viz.kmer_count_barplot import kmer_count_barplot as jax_barplot
    from seekr_tpu_torch.viz.kmer_count_barplot import kmer_count_barplot

    fa, mean, std = norm_fixture
    calls = capture(monkeypatch, seaborn, "barplot", ("x", "y", "hue"))
    kw = dict(sortmethod=sortmethod, topkmernumber=topk, pformat="png", pdpi=72)
    ours, theirs = run_both(
        capsys,
        lambda: kmer_count_barplot(fa, mean, std, 2, outputname=str(tmp_path / "t"),
                                   device=CPU, **kw),
        lambda: jax_barplot(fa, mean, std, 2, outputname=str(tmp_path / "j"), **kw))
    assert ours == theirs and "more than 10 input sequences" in ours
    assert ("Only 16 kmer words" in ours) == (topk > 16)
    got, want = calls
    assert isinstance(got["data"], dict) and len(got["data"]["Kword"]) == 10 * min(topk, 16)
    assert_same_rows(got["data"], want["data"])
    assert [got[k] for k in ("x", "y", "hue")] == [want[k] for k in ("x", "y", "hue")]


@pytest.mark.parametrize("sortstat,sortmethod,topk", [
    ("mean", "descending", 10), ("sd", "upwards", 4), ("median", "ascending", 20)])
def test_msd_barplot_rows_match(norm_fixture, tmp_path, monkeypatch, capsys, sortstat,
                                sortmethod, topk):
    import seaborn

    from seekr_tpu.viz.kmer_msd_barplot import kmer_msd_barplot as jax_barplot
    from seekr_tpu_torch.viz.kmer_msd_barplot import kmer_msd_barplot

    fa, mean, std = norm_fixture
    calls = capture(monkeypatch, seaborn, "barplot", ("x", "y", "hue"))
    kw = dict(sortstat=sortstat, sortmethod=sortmethod, topkmernumber=topk,
              pformat="png", pdpi=72)
    ours, theirs = run_both(
        capsys,
        lambda: kmer_msd_barplot(fa, mean, std, 2, outputname=str(tmp_path / "t"),
                                 device=CPU, **kw),
        lambda: jax_barplot(fa, mean, std, 2, outputname=str(tmp_path / "j"), **kw))
    assert ours == theirs
    got, want = calls
    assert_same_rows(got["data"], want["data"])
    assert [got[k] for k in ("x", "y", "hue")] == [want[k] for k in ("x", "y", "hue")]


def test_long_form_is_pandas_bit_for_bit():
    """Column statistics, sort order (ties included) and melt against pandas."""
    from seekr_tpu_torch.viz import long_form

    rng = np.random.default_rng(7)
    counts = rng.normal(size=(13, 64)).astype(np.float32)
    counts[:, 5] = counts[:, 9]  # two tied columns: the unstable order must match
    counts[:, 20] = counts[:, 3]
    frame = pd.DataFrame(counts, index=[f"h{i}" for i in range(13)],
                         columns=[f"w{j}" for j in range(64)])
    assert long_form.column_mean(counts).tobytes() == frame.mean().to_numpy().tobytes()
    assert long_form.column_sd(counts).tobytes() == frame.std().to_numpy().tobytes()
    dev = (frame - frame.mean()).abs().sum()
    assert long_form.abs_deviation_sum(counts).tobytes() == dev.to_numpy().tobytes()
    kmers = list(frame.columns)
    for stat in (dev, frame.mean(), frame.std()):
        for ascending in (True, False):
            order = long_form.sort_order(stat.to_numpy(), ascending)
            assert [kmers[j] for j in order] == list(stat.sort_values(
                ascending=ascending).index)
    order = long_form.sort_order(dev.to_numpy(), True)
    melted = frame[[kmers[j] for j in order]].reset_index().melt(
        id_vars="index", value_vars=[kmers[j] for j in order])
    got = long_form.melt(counts, list(frame.index), kmers, order)
    assert got["Sample"] == list(melted["index"]) and got["Kword"] == list(melted["variable"])
    assert got["Value"].tobytes() == melted["value"].to_numpy().tobytes()


def test_norm_mismatch_returns_none(norm_fixture, tmp_path, capsys):
    from seekr_tpu.viz import kmer_count_barplot as jax_count
    from seekr_tpu.viz import kmer_msd_barplot as jax_msd
    from seekr_tpu_torch.viz import kmer_count_barplot, kmer_msd_barplot

    fa, mean, std = norm_fixture
    for ours, theirs in ((kmer_count_barplot, jax_count), (kmer_msd_barplot, jax_msd)):
        assert ours(fa, mean, std, 3, device=CPU) is None
        printed = capsys.readouterr().out
        assert theirs(fa, mean, std, 3) is None
        assert printed == capsys.readouterr().out and "The output is None" in printed


# -- textplots ---------------------------------------------------------------

@pytest.fixture(scope="module")
def text_fastas(tmp_path_factory):
    root = tmp_path_factory.mktemp("text")
    rng = np.random.default_rng(9)
    seqs = ["".join(rng.choice(list("ACGT"), size=n)) for n in (50, 36, 20)]
    seqs[0] = seqs[0][:20] + "AAAATTAAAA" + seqs[0][30:]  # overlapping words
    write_fasta(str(root / "a.fa"), ["alpha|x|1", "beta|y", "gamma"], seqs)
    write_fasta(str(root / "b.fa"), ["delta"], [seqs[1]])
    return root, seqs


def capture_drawing(monkeypatch):
    """Every rectangle and glyph added to an Axes, in order."""
    from matplotlib.axes import Axes

    drawn = []
    add_patch, text = Axes.add_patch, Axes.text

    def patch(self, p):
        drawn.append(("rect", p.get_xy(), p.get_width(), p.get_height(),
                      tuple(p.get_facecolor())))
        return add_patch(self, p)

    def glyph(self, x, y, s, **kw):
        drawn.append(("text", x, y, s, kw.get("color"), kw.get("weight"),
                      kw.get("fontsize")))
        return text(self, x, y, s, **kw)

    monkeypatch.setattr(Axes, "add_patch", patch)
    monkeypatch.setattr(Axes, "text", glyph)
    return drawn


@pytest.mark.parametrize("words,colors", [
    (["AAAA", "TTA", "GC"], "default"),
    (["AAAA", "TTA"], ["#000000", "#00ff00"]),
    (["AAAA", "TTA"], ["#000000"]),                      # wrong length: default
    ([f"A{c}" for c in "ACGTACGTACGT"], "default"),       # more than 10 words
])
def test_words_and_colors_resolve_the_same(capsys, words, colors):
    got = textplot._resolve_words_colors(words, colors)
    printed = capsys.readouterr().out
    assert got == jax_textplot._resolve_words_colors(words, colors)
    assert printed == capsys.readouterr().out


@pytest.mark.parametrize("words,colors", [(["AAAA", "TTA", "GC"], "default"),
                                          (["AAAA", "TTA"], ["#000000", "#00ff00"])])
def test_textplots_draw_the_same(text_fastas, tmp_path, monkeypatch, capsys, words,
                                 colors):
    root, _ = text_fastas
    drawn = capture_drawing(monkeypatch)
    a, b = str(root / "a.fa"), str(root / "b.fa")
    kw = dict(wraplen=16, plotformat="png", plotdpi=72)
    ours, theirs = run_both(
        capsys,
        lambda: textplot.kmer_comp_textplot(a, b, words, colors,
                                            outputname=str(tmp_path / "t_comp"), **kw),
        lambda: jax_textplot.kmer_comp_textplot(a, b, words, colors,
                                                outputname=str(tmp_path / "j_comp"), **kw))
    assert ours == theirs
    half = len(drawn) // 2
    assert half > 0 and drawn[:half] == drawn[half:]
    drawn.clear()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ours, theirs = run_both(
        capsys,
        lambda: textplot.kmer_indi_textplot(a, words, colors,
                                            outputpath=f"{tmp_path}/t/", **kw),
        lambda: jax_textplot.kmer_indi_textplot(a, words, colors,
                                                outputpath=f"{tmp_path}/j/", **kw))
    assert ours == theirs
    half = len(drawn) // 2
    assert drawn[:half] == drawn[half:]
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == ["alpha.png", "beta.png", "gamma.png"]


def test_word_coordinates_and_colors(text_fastas):
    _, seqs = text_fastas
    for seq in seqs:
        for word in ("AAAA", "A", "TTAA", "GCG", "N"):
            got = textplot.find_word_coordinates(seq, word)
            assert got.tolist() == jax_textplot.find_word_coordinates(seq, word).tolist()
        matched, flat = textplot._match_info(seq, ["AAAA", "TTA"])
        want, want_flat = jax_textplot._match_info(seq, ["AAAA", "TTA"])
        assert flat == want_flat
        for pos in range(len(seq)):
            assert textplot.ass_color(pos, matched, ["r", "g"]) == \
                jax_textplot.ass_color(pos, want, ["r", "g"])


# -- visualize_distro --------------------------------------------------------

@pytest.fixture(scope="module")
def matrices(tmp_path_factory):
    root = tmp_path_factory.mktemp("distro")
    rng = np.random.default_rng(12)
    a = rng.normal(size=(40, 40))
    sym = np.corrcoef(a)
    sym[2, 5] = sym[5, 2] = np.nan
    rect = rng.normal(size=(30, 50))
    np.save(root / "sym.npy", sym)
    np.save(root / "rect.npy", rect)
    names = [f"r{i}" for i in range(40)]
    pd.DataFrame(sym, names, names).to_csv(root / "sym.csv")
    return root


@pytest.mark.parametrize("name,symmetric", [("sym.npy", None), ("sym.npy", False),
                                            ("rect.npy", None), ("sym.csv", None),
                                            ("sym.csv", True)])
def test_distro_values_equal(matrices, name, symmetric):
    path = str(matrices / name)
    got = distro.distro_values(path, symmetric=symmetric)
    want = jax_distro.distro_values(path, symmetric=symmetric)
    if name.endswith(".csv"):
        # the port's reader returns the written 17-digit values exactly; pandas'
        # default float parser is not correctly rounded (most of these cells land
        # an ulp or so away)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    else:
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name,symmetric", [("sym.npy", None), ("sym.npy", False),
                                            ("rect.npy", None)])
def test_stream_distro_stats_equal(matrices, name, symmetric):
    path = str(matrices / name)
    kw = dict(bins=20, fine_bins=1 << 12, chunk_cells=300, symmetric=symmetric)
    got = distro.stream_distro_stats(path, **kw)
    want = jax_distro.stream_distro_stats(path, **kw)
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    with pytest.raises(ValueError, match="square"):
        distro.stream_distro_stats(str(matrices / "rect.npy"), symmetric=True)


@pytest.mark.parametrize("stream", [None, True])
def test_visualize_distro_histogram_and_title(matrices, tmp_path, monkeypatch, capsys,
                                              stream):
    from matplotlib.axes import Axes

    titles, set_title = [], Axes.set_title
    monkeypatch.setattr(Axes, "set_title",
                        lambda self, label, **kw: titles.append(label) or set_title(
                            self, label, **kw))
    path = str(matrices / "sym.npy")
    got = distro.visualize_distro(path, outputname=str(tmp_path / "t"), bins=20,
                                  pformat="png", pdpi=72, stream=stream)
    want = jax_distro.visualize_distro(path, outputname=str(tmp_path / "j"), bins=20,
                                       pformat="png", pdpi=72, stream=stream)
    for g, w in zip(got if stream else [got], want if stream else [want]):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    assert len(titles) == 2 and titles[0] == titles[1]
    assert (tmp_path / "t.png").stat().st_size > 0
    empty = tmp_path / "empty.npy"
    np.save(empty, np.full((3, 3), np.nan))
    assert distro.visualize_distro(str(empty), outputname=str(tmp_path / "e")) is None
    assert "no finite values" in capsys.readouterr().out
    with pytest.raises(ValueError, match="needs a .npy"):
        distro.visualize_distro(str(matrices / "sym.csv"), stream=True)


# -- style -------------------------------------------------------------------

def test_fonts_are_the_ports_own(tmp_path):
    import matplotlib.pyplot as plt

    from seekr_tpu_torch.viz import style

    root = Path(style.__file__).resolve().parents[1] / "data"
    assert all(os.path.normpath(p).startswith(str(root)) for p in style._FONT_PATHS)
    assert (root / "default_plot_font.ttf").stat().st_size > 0
    assert (root / "LICENSE_DEJAVU").exists()
    style.setup_fonts()
    assert plt.rcParams["font.family"] == ["DejaVu Sans"]
    assert matplotlib.rcParams["pdf.fonttype"] == 42
    assert style.is_hex_color("#a0B1c2") and not style.is_hex_color("#a0B1c")
    assert style.check_hex_colors(["#000000", "#ffffff"])
    assert not style.check_hex_colors(["#000000", 3])
