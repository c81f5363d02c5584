"""The port's legacy community graph (``graph.maker.Maker``), network plot
(``graph.kmer_leiden.plot_network``) and fit plot (``stats.find_dist.plot_fits``)
against seekr_tpu's, on the CPU.

Inputs: the five-row adjacency of ``tests/test_graph_maker.py`` (the sign
pattern of the reference fixture), seeded 24-row correlation matrices with
string and integer labels, and a disconnected graph.  Everything is compared
for equality: the thresholded matrix in place, the GML bytes, membership and
modularity under one seed, ``membership2attribute``, the node->Group CSV bytes,
the plotted edge list with its colors and widths, and the fit plot's histogram
and PDF arrays.
"""

import importlib

import matplotlib

matplotlib.use("Agg")

import networkx
import numpy as np
import pandas as pd
import pytest

from seekr_tpu.graph.maker import Maker as JaxMaker
from seekr_tpu_torch.graph.maker import Maker, _relabel_by_size, _unweighted_modularity
from seekr_tpu_torch.io.fast_csv import LabeledMatrix

jax_leiden = importlib.import_module("seekr_tpu.graph.kmer_leiden")
leiden = importlib.import_module("seekr_tpu_torch.graph.kmer_leiden")


def local_rows():
    """``tests/test_graph_maker.py``'s five rows: after the sign flip, pair
    (0, 1) is the one negative adjacency entry."""
    e = np.zeros((4, 16))
    for i in range(4):
        e[i, 2 * i], e[i, 2 * i + 1] = 1.0, -1.0
    a = e[0] + 0.3 * e[2]
    b = -0.5 * e[0] + 0.866 * e[1] + 0.3 * e[2]
    c = -0.5 * e[0] - 0.866 * e[1] + 0.3 * e[2]
    return np.stack([-e[2] + 0.5 * e[3], -e[2] - 0.5 * e[3], a, b, c])


def adjacency(case):
    """(values, labels) of one seeded case."""
    if case == "five":
        return np.corrcoef(local_rows()) * -1, list(range(5))
    rng = np.random.default_rng(21)
    # three blocks of eight rows around shared centres, so communities exist
    centres = rng.normal(size=(3, 30))
    x = np.repeat(centres, 8, axis=0) + 0.9 * rng.normal(size=(24, 30))
    labels = [f"t{i}" for i in range(24)] if case == "strings" else list(range(100, 124))
    return np.corrcoef(x), labels


def build_both(tmp_path, case, **kwargs):
    values, labels = adjacency(case)
    ours = Maker(LabeledMatrix(values.copy(), labels, labels),
                 gml_path=str(tmp_path / "t.gml"), csv_path=str(tmp_path / "t.csv"),
                 seed=0, **kwargs)
    theirs = JaxMaker(pd.DataFrame(values.copy(), labels, labels),
                      gml_path=str(tmp_path / "j.gml"), csv_path=str(tmp_path / "j.csv"),
                      seed=0, **kwargs)
    return ours, theirs


@pytest.mark.parametrize("labeled", [True, False], ids=["labeled", "ndarray"])
def test_apply_threshold_in_place(labeled):
    values, labels = adjacency("strings")
    caller = LabeledMatrix(values.copy(), labels, labels) if labeled else values.copy()
    maker = Maker(caller, threshold=0.1)
    maker.apply_threshold()
    frame = pd.DataFrame(values.copy(), labels, labels)
    JaxMaker(frame, threshold=0.1).apply_threshold()
    mutated = caller.values if labeled else caller
    assert maker.adj is caller
    np.testing.assert_array_equal(mutated, frame.to_numpy())
    assert (np.diag(mutated) == 0).all() and (mutated[mutated != 0] >= 0.1).all()
    readonly = values.copy()
    readonly.flags.writeable = False
    maker = Maker(readonly, threshold=0.1)
    maker.apply_threshold()  # a read-only array is copied, not written
    np.testing.assert_array_equal(maker.adj, frame.to_numpy())


@pytest.mark.parametrize("case,kwargs", [
    ("five", {}),
    ("strings", {"threshold": 0.05}),
    ("strings", {"threshold": 0.2, "gamma": 2.0, "n_comms": 2}),
    ("integers", {"threshold": -0.1, "n_comms": 10}),
])
def test_make_gml_csv_files_equal(tmp_path, case, kwargs):
    ours, theirs = build_both(tmp_path, case, **kwargs)
    got, want = ours.make_gml_csv_files(), theirs.make_gml_csv_files()
    assert got == want
    assert (tmp_path / "t.gml").read_bytes() == (tmp_path / "j.gml").read_bytes()
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert ours.partition.membership == theirs.partition.membership
    assert ours.partition.modularity == theirs.partition.modularity


def test_partition_steps_equal(tmp_path):
    ours, theirs = build_both(tmp_path, "strings", threshold=0.05)
    for maker in (ours, theirs):
        maker.build()
        maker.save(main_sub=True)
    assert (tmp_path / "t.gml").read_bytes() == (tmp_path / "j.gml").read_bytes()
    got, want = ours.get_partition(), theirs.get_partition()
    assert got.membership == want.membership and got.modularity == want.modularity
    assert ours.membership2attribute() == theirs.membership2attribute()
    assert ours.adj is None and list(ours.main_sub) == list(theirs.main_sub)


def disconnected_graph():
    g = networkx.Graph()
    g.add_edges_from([(0, 1), (0, 2), (0, 3), (1, 2), (2, 4), (2, 5), (2, 6), (7, 8),
                      (8, 9)])
    networkx.set_edge_attributes(g, 1, "weight")
    return g


@pytest.mark.parametrize("n_comms,gamma", [(5, 1.0), (1, 1.0), (3, 10.0)])
def test_disconnected_groups_equal(tmp_path, n_comms, gamma):
    groups = []
    for cls, name in ((Maker, "t"), (JaxMaker, "j")):
        maker = cls(gml_path=str(tmp_path / f"{name}.gml"), n_comms=n_comms, gamma=gamma)
        maker.graph = disconnected_graph()
        maker.find_main_sub()
        maker.save(True)
        maker.get_partition()
        groups.append(maker.membership2attribute())
    assert groups[0] == groups[1]


def test_stale_gml_raises_like_seekr_tpu(tmp_path):
    ours, theirs = build_both(tmp_path, "strings", threshold=0.05)
    for maker in (ours, theirs):
        maker.build()
        maker.save(main_sub=True)
        maker.graph = disconnected_graph()  # nodes the GML does not have
        with pytest.raises(ValueError, match="stale"):
            maker.membership2attribute()


def test_helpers_equal():
    from seekr_tpu.graph import maker as jax_maker

    rng = np.random.default_rng(3)
    membership = rng.integers(0, 6, size=40)
    edges = rng.integers(0, 40, size=(90, 2))
    np.testing.assert_array_equal(_relabel_by_size(membership),
                                  jax_maker._relabel_by_size(membership))
    assert _unweighted_modularity(40, edges, membership) == \
        jax_maker._unweighted_modularity(40, edges, membership)
    assert _unweighted_modularity(4, [], [0, 1, 2, 3]) == 0.0


# -- plots -------------------------------------------------------------------

def thresholded(cutoff=0.1):
    values, labels = adjacency("strings")
    values = values.copy()
    values[values < cutoff] = 0
    np.fill_diagonal(values, 0)
    return LabeledMatrix(values, labels, labels), pd.DataFrame(values, labels, labels)


@pytest.mark.parametrize("method", ["gradient", "threshold", "rainbow"])
def test_plot_network_edges_and_styles_equal(tmp_path, monkeypatch, capsys, method):
    labeled, frame = thresholded()
    membership = leiden.leiden_membership(labeled, setseed=True)
    calls = []
    draw = networkx.draw_networkx_edges

    def recorder(G, pos, **kw):
        calls.append((list(G.edges(data="weight")), kw["edge_color"], kw["width"]))
        return draw(G, pos, **kw)

    monkeypatch.setattr(networkx, "draw_networkx_edges", recorder)
    leiden.plot_network(labeled, membership, str(tmp_path / "t"), edgecolormethod=method,
                        edgethreshold=0.3)
    printed = capsys.readouterr().out
    jax_leiden.plot_network(frame, membership, str(tmp_path / "j"), edgecolormethod=method,
                            edgethreshold=0.3)
    assert printed == capsys.readouterr().out
    (edges, colors, widths), (want_edges, want_colors, want_widths) = calls
    assert edges == want_edges and len(edges) == len(colors) > 0
    assert colors == want_colors and widths == want_widths
    assert (tmp_path / "t.pdf").stat().st_size > 0


def test_plot_fits_arrays_equal(tmp_path, monkeypatch, capsys):
    from matplotlib.axes import Axes

    from seekr_tpu.stats.find_dist import plot_fits as jax_plot_fits
    from seekr_tpu_torch.stats.find_dist import plot_fits

    data = np.random.default_rng(4).normal(0.1, 0.05, size=2000)
    params = {"norm": (0.1, 0.05), "cauchy": (0.1, 0.03), "uniform": (-0.1, 0.4),
              "expon": (-0.1, 0.2), "rayleigh": (-0.1, 0.15), "logistic": (0.1, 0.03)}
    results = [(name, 0.01 * (i + 1), p) for i, (name, p) in enumerate(params.items())]
    drawn = []
    hist, plot = Axes.hist, Axes.plot
    monkeypatch.setattr(Axes, "hist", lambda self, x, **kw: drawn.append(
        ("hist", np.asarray(x).tobytes(), kw)) or hist(self, x, **kw))
    monkeypatch.setattr(Axes, "plot", lambda self, x, y, fmt, **kw: drawn.append(
        ("plot", np.asarray(x).tobytes(), np.asarray(y).tobytes(), fmt, kw))
        or plot(self, x, y, fmt, **kw))
    plot_fits(data, results, str(tmp_path / "t"))
    jax_plot_fits(data, results, str(tmp_path / "j"))
    half = len(drawn) // 2
    assert half == 2 * len(results) and drawn[:half] == drawn[half:]
    assert (tmp_path / "t.pdf").stat().st_size > 0
    plot_fits(data, [], str(tmp_path / "none"))
    printed = capsys.readouterr().out
    jax_plot_fits(data, [], str(tmp_path / "none"))
    assert printed == capsys.readouterr().out and "skipping the fit plot" in printed
    assert not (tmp_path / "none.pdf").exists()
