"""Leiden community network for fasta sequences.

Port of ``seekr_tpu/graph/kmer_leiden.py:39-344`` (behavioural parity with
seekr/kmer_leiden.py:66-346): counts and the self-Pearson on the card, r below
the cutoff and the diagonal zeroed, an undirected weighted graph, a Leiden
partition by the host C++ engine (``native.leiden``: the six partition types of
the reference, with its resolution and seed rules, kmer_leiden.py:115-146), and
the Gephi nodes/edges CSVs, written without pandas in the bytes seekr_tpu's
``to_csv`` writes, and the spring-layout network plot (``plot_network``;
matplotlib and networkx are imported when it draws).

``data_parallel`` runs the similarity GEMM data-sharded over a device mesh and
implies the streamed edge extraction, as in seekr_tpu.
"""

from __future__ import annotations

import numpy as np

from seekr_tpu_torch import native
from seekr_tpu_torch.io.fast_csv import LabeledMatrix, _quote, _shortest_cells
from seekr_tpu_torch.models.counter import KmerCounter
from seekr_tpu_torch.models.pearson import mirror_upper_inplace, pearson
from seekr_tpu_torch.ops.pearson import _RowFiller
from seekr_tpu_torch.utils.device import resolve_device

# Auto-stream cutover (cells of the self-similarity square), far above
# io.stream.STREAM_CELL_THRESHOLD: streaming changes the artifacts (the Gephi
# edges file holds the detected edges instead of the full triangle melt), so it
# starts only where the dense path stops being comfortable: 2.5e9 cells is
# m = 50k, a 10 GB float32 matrix.  stream=True / --stream on forces it.
LEIDEN_STREAM_CELL_THRESHOLD = 2_500_000_000

# partition types whose find_partition call takes resolution_parameter
# (reference kmer_leiden.py:131-146)
_RESOLUTION_ALGOS = {
    "RBConfigurationVertexPartition",
    "RBERVertexPartition",
    "CPMVertexPartition",
}


def similarity_graph(inputfile, mean, std, k, pearsoncutoff=0, counter=None,
                     mesh=None, device=None) -> LabeledMatrix:
    """Thresholded self-similarity with the headers as labels.

    r < pearsoncutoff -> 0; diagonal -> 0 (reference kmer_leiden.py:93-96).
    ``counter`` reuses a KmerCounter already built for the same file.  The
    counts stay on the card into ``pearson``; only the [m, m] matrix comes to
    the host.  ``mesh`` runs the GEMM data-sharded (the matrix is still
    gathered on the host, then mirrored to exact symmetry).
    """
    if counter is None:
        counter = KmerCounter(inputfile, mean=mean, std=std, k=k, silent=True,
                              device=device)
    headers = [h[1:] for h in counter.headers]
    counts = counter.get_counts_device()
    if mesh is None:
        sim = pearson(counts, counts, device=counter.device)
    else:
        from seekr_tpu_torch.parallel.dist import stream_pearson_sharded

        # filled in place: collected blocks and a vstack would hold it twice
        m = int(counts.shape[0])
        sim = np.empty((m, m), dtype=np.float32)
        stream_pearson_sharded(mesh, counts, _RowFiller(sim))
        mirror_upper_inplace(sim)
    sim[sim < pearsoncutoff] = 0
    np.fill_diagonal(sim, 0)
    return LabeledMatrix(sim, headers, headers)


def _run_leiden(src, dst, weights, n_nodes, algo, rs, setseed):
    """Native Leiden on an explicit undirected edge list."""
    if algo not in native.ALGORITHMS:
        raise ValueError(f"algo must be one of {list(native.ALGORITHMS)}, got {algo!r}")
    # Significance is defined for unweighted graphs only; the reference runs it
    # without weights (kmer_leiden.py:131-134): every edge counts as 1
    if algo == "SignificanceVertexPartition":
        weights = None
    elif weights is not None:
        weights = np.asarray(weights, np.float64)
    resolution = rs if algo in _RESOLUTION_ALGOS else 1.0
    seed = 1 if setseed else None
    return native.leiden(np.asarray(src, np.int64), np.asarray(dst, np.int64), weights,
                         n_nodes=n_nodes, algo=algo, resolution=resolution, seed=seed)


def leiden_membership(graph, algo="RBERVertexPartition", rs=1.0, setseed=False):
    """Run the native Leiden engine on a thresholded similarity matrix
    (a ``LabeledMatrix`` from ``similarity_graph``, or its values)."""
    vals = graph.values if isinstance(graph, LabeledMatrix) else np.asarray(graph)
    src, dst = np.nonzero(np.triu(vals > 0, k=1))
    return _run_leiden(src, dst, vals[src, dst], vals.shape[0], algo, rs, setseed)


class _EdgeTiles:
    """Streamed thresholded edge extraction from self-similarity tiles.

    Keeps only the strict-upper entries passing the reference's edge rule --
    ``sim[sim < cutoff] = 0`` then ``> 0`` (kmer_leiden.py:93-96,106), i.e.
    ``r >= cutoff and r > 0`` -- as the [block, m] tiles come off the card, so
    host memory holds the sparse edge set instead of the [m, m] square.
    """

    def __init__(self, m: int, cutoff: float):
        self.m = int(m)
        self.cutoff = cutoff
        self._row = 0
        # int32 node ids while accumulating: at a low cutoff the edge set, not
        # the tiles, is the memory high-water mark
        self._cols = np.arange(self.m, dtype=np.int32)
        self.src, self.dst, self.w = [], [], []

    def append(self, tile):
        t = np.asarray(tile)
        rows = np.arange(self._row, self._row + t.shape[0], dtype=np.int32)
        mask = ((self._cols[None, :] > rows[:, None]) & (t >= self.cutoff) & (t > 0))
        si, dj = np.nonzero(mask)
        self.src.append(rows[si])
        self.dst.append(dj.astype(np.int32))
        self.w.append(t[si, dj])
        self._row += t.shape[0]

    def result(self):
        if self._row != self.m:
            raise AssertionError(f"expected {self.m} rows, saw {self._row}")
        return (np.concatenate(self.src) if self.src else np.empty(0, np.int32),
                np.concatenate(self.dst) if self.dst else np.empty(0, np.int32),
                np.concatenate(self.w) if self.w else np.empty(0, np.float32))


def sparse_similarity_edges(counts, pearsoncutoff=0, mesh=None, block_rows: int = 2048,
                            device=None):
    """(src, dst, weights) of the thresholded self-similarity graph, extracted
    tile by tile from the blocked GEMM (data-sharded over ``mesh`` when given):
    the [m, m] matrix never exists on the host."""
    tiles = _EdgeTiles(int(counts.shape[0]), pearsoncutoff)
    if mesh is None:
        from seekr_tpu_torch.io.stream import stream_pearson

        stream_pearson(counts, counts, tiles, block_rows=block_rows, device=device)
    else:
        from seekr_tpu_torch.parallel.dist import stream_pearson_sharded

        stream_pearson_sharded(mesh, counts, tiles, block_rows=block_rows)
    return tiles.result()


def _edge_style(graph: LabeledMatrix, edgecolormethod, edgethreshold):
    """Edge colors and widths of the upper-triangle positive weights, row by row.

    'gradient': weights min-max mapped to [0.1, 1] grey scale + width 1..4;
    'threshold': black/4pt above the threshold else grey/1pt
    (reference kmer_leiden.py:154-241).
    """
    row, col = np.triu_indices(graph.shape[0], k=1)
    weights = graph.values[row, col]
    weights = weights[weights > 0]
    if edgecolormethod == "threshold":
        colors = ["black" if w > edgethreshold else "grey" for w in weights]
        widths = [4 if w > edgethreshold else 1 for w in weights]
        return colors, widths
    if edgecolormethod != "gradient":
        print("edgecolormethod must be either 'gradient' or 'threshold', "
              "use default 'gradient' now")
    if not len(weights):  # no pair cleared the cutoff: nothing to style
        return [], []
    span = weights.max() - weights.min()
    normalized = (weights - weights.min()) / (span if span > 0 else 1.0)
    mapped = 0.1 + 0.9 * normalized
    colors = [(1 - w, 1 - w, 1 - w) for w in mapped]
    widths = [1 + 3 * w for w in mapped]
    return colors, widths


def plot_network(graph: LabeledMatrix, membership, plotname, edgecolormethod="gradient",
                 edgethreshold=0.1, labelfontsize=12):
    """Spring-layout community plot saved as ``{plotname}.pdf``.

    The graph holds the positive weights only, the edge set the communities
    were found on (seekr_tpu's documented deviation: the reference plots every
    nonzero entry, which desynchronizes the styling arrays from the edges under
    a negative cutoff).  ``from_numpy_array`` adds the edges row by row over the
    upper triangle, the order of ``_edge_style``'s arrays, as seekr_tpu's
    ``from_pandas_adjacency`` does.
    """
    from seekr_tpu_torch.viz.style import ensure_headless_backend

    ensure_headless_backend()
    import matplotlib.pyplot as plt
    import networkx as nx

    vals = graph.values
    G = nx.relabel_nodes(nx.from_numpy_array(np.where(vals > 0, vals, 0.0)),
                         dict(enumerate(graph.columns)))
    edge_colors, edge_widths = _edge_style(graph, edgecolormethod, edgethreshold)
    community_colors = plt.cm.rainbow(np.linspace(0, 1, int(membership.max()) + 1))
    node_colors = [community_colors[c] for c in membership]
    pos = nx.spring_layout(G, weight="weight")
    plt.figure(figsize=(15, 15))
    plt.gca().axis("off")
    nx.draw_networkx_nodes(G, pos, node_color=node_colors, node_size=500)
    nx.draw_networkx_edges(G, pos, edge_color=edge_colors, width=edge_widths)
    nx.draw_networkx_labels(G, pos, font_size=labelfontsize, font_family="sans-serif")
    plt.tight_layout()
    plt.savefig(f"{plotname}.pdf")
    plt.close()


def _write_rows(path, header: str, columns) -> None:
    """A CSV of already-formatted cell columns (equal-length lists of str)."""
    with open(path, "w", newline="") as fh:
        fh.write(header)
        fh.writelines(",".join(cells) + "\n" for cells in zip(*columns))


def _weight_cells(w) -> list:
    """Weights as pandas' ``to_csv`` writes a float column: the shortest repr
    of each value at its width."""
    return [c.decode() for c in _shortest_cells(np.asarray(w)[None, :])[0]]


def _write_gephi_nodes(names, membership, csvfile):
    """The nodes file of both exporters: rows ordered by community (a stable
    argsort, so ascending node index within one), 1-based ids in Color."""
    membership = np.asarray(membership)
    order = np.argsort(membership, kind="stable")
    labels = [_quote(names[i]) for i in order]
    colors = [str(int(c) + 1) for c in membership[order]]
    _write_rows(f"{csvfile}_nodes_leiden.csv", "Id,Label,Color\n", (labels, labels, colors))


def _write_gephi_edges(names, src, dst, w, csvfile):
    quoted = [_quote(n) for n in names]
    _write_rows(f"{csvfile}_edges_leiden.csv", "Source,Target,Weight\n",
                ([quoted[i] for i in src], [quoted[j] for j in dst], _weight_cells(w)))


def export_gephi_csv(graph: LabeledMatrix, membership, csvfile):
    """Write ``{csvfile}_nodes_leiden.csv`` / ``{csvfile}_edges_leiden.csv``.

    The schema of reference kmer_leiden.py:319-346: nodes ordered by community
    (Id, Label, Color with 1-based community ids); edges the upper-triangle
    melt (Source, Target, Weight) of every cell but the NaN ones (seekr_tpu's
    explicit ``dropna``), row by row.
    """
    names = list(graph.index)
    _write_gephi_nodes(names, membership, csvfile)
    src, dst = np.nonzero(np.triu(~np.isnan(graph.values), k=1))
    _write_gephi_edges(names, src, dst, graph.values[src, dst], csvfile)


def export_gephi_csv_edges(names, membership, src, dst, w, csvfile):
    """Streamed-mode Gephi export: the same nodes file as export_gephi_csv; the
    edges file holds the detected edge set (positive post-cutoff triangle
    entries) instead of the reference's every-cell melt, which at streaming
    scale is the matrix itself (seekr_tpu's documented deviation)."""
    _write_gephi_nodes(names, membership, csvfile)
    _write_gephi_edges(names, src, dst, w, csvfile)


def kmer_leiden(inputfile, mean, std, k, algo="RBERVertexPartition", rs=1.0,
                pearsoncutoff=0, setseed=False, edgecolormethod="gradient",
                edgethreshold=0.1, labelfontsize=12, plotname=None, csvfile=None,
                stream=None, data_parallel=None, device=None):
    """Leiden community membership of the sequences of ``inputfile``.

    seekr_tpu's signature plus ``device`` (``None`` = the first CUDA card);
    returns the int32 membership (the reference returns None), or None when
    the norm vectors do not fit ``k``.  Above ``LEIDEN_STREAM_CELL_THRESHOLD``
    similarity cells, or with ``stream=True`` or ``data_parallel`` (a mesh of
    that many devices of ``device``'s kind, which shards the GEMM), the
    thresholded edge set is extracted tile by tile
    (``sparse_similarity_edges``), the Gephi edges
    file holds the detected edges and the plot is skipped with a message.
    Streamed weights may differ from the dense ones by GEMM-tiling ulps, so a
    pair within an ulp of the cutoff can flip.  ``plotname`` asks for the
    network plot ``{plotname}.pdf``, which ``edgecolormethod``,
    ``edgethreshold`` and ``labelfontsize`` style.
    """
    from seekr_tpu_torch.viz.style import check_norm_compat

    from seekr_tpu_torch.parallel.mesh import build_mesh_from_flags

    # the reference's intended check (upstream kmer_leiden.py:75 has the same
    # operator-precedence bug as find_pval.py:76)
    if not check_norm_compat(mean, std, k, "Leiden community is calculated or plotted"):
        return None

    device = resolve_device(device)
    mesh = build_mesh_from_flags(data_parallel, device=device)
    counter = KmerCounter(inputfile, mean=mean, std=std, k=k, silent=True, device=device)
    m = len(counter.headers)
    do_stream = (stream if stream is not None
                 else m * m > LEIDEN_STREAM_CELL_THRESHOLD or mesh is not None)

    if do_stream:
        names = [h[1:] for h in counter.headers]
        src, dst, w = sparse_similarity_edges(counter.get_counts_device(), pearsoncutoff,
                                              mesh=mesh, device=counter.device)
        membership = _run_leiden(src, dst, w, m, algo, rs, setseed)
        if plotname:
            print(f"kmer_leiden: streamed mode at m={m} skips the "
                  f"spring-layout plot ({plotname}.pdf not written) — "
                  "it needs the dense similarity matrix; use the Gephi "
                  "CSVs (csvfile=) for large-graph rendering.")
        if csvfile:
            export_gephi_csv_edges(names, membership, src, dst, w, csvfile)
        return membership

    graph = similarity_graph(inputfile, mean, std, k, pearsoncutoff, counter=counter,
                             mesh=mesh)
    membership = leiden_membership(graph, algo=algo, rs=rs, setseed=setseed)
    if plotname:
        plot_network(graph, membership, plotname, edgecolormethod=edgecolormethod,
                     edgethreshold=edgethreshold, labelfontsize=labelfontsize)
    if csvfile:
        export_gephi_csv(graph, membership, csvfile)
    return membership
