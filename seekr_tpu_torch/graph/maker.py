"""Louvain-style community graph from an adjacency matrix (legacy
``seekr.graph.Maker`` / ``seekr_graph``).

Port of ``seekr_tpu/graph/maker.py``, which reconstructs the legacy 1.x
capability the reference dropped in its 2.0 rewrite (its 2.0 successor is
``kmer_leiden``); the behavioral contract is pinned by the reference's shipped
legacy tests (seekr/tests/test_graph.py):

  * ``apply_threshold`` zeroes sub-threshold entries and the diagonal
    IN PLACE on the caller's matrix (test_apply_threshold asserts the
    caller's DataFrame mutates; here a ``LabeledMatrix`` or an ndarray).
  * ``build`` -> undirected weighted :mod:`networkx` graph with
    stringified node names, positive-weight edges only, adjacency
    cleared afterwards, largest connected component in ``main_sub``.
  * ``save``/``get_partition`` round-trip through the GML file (the
    legacy ran igraph on the written GML, so partitioning reads the
    file, not the in-memory graph).
  * ``get_partition`` optimizes *weighted* modularity at resolution
    ``gamma`` (the port's native C++ Leiden engine,
    ``seekr_tpu_torch.native``, replaces python-louvain/igraph)
    but reports the *unweighted* Newman modularity of the result —
    test_get_partition's golden -0.08024691358024699 is exactly the
    unweighted modularity of the weighted-optimal partition, which
    pins this legacy quirk.
  * community labels are ordered by size (largest first), ties broken
    by first node appearance — pinned by the [1, 0, 1, 0, 0] golden.
  * ``membership2attribute`` caps group ids at ``n_comms`` and assigns
    each connected component outside ``main_sub`` the next id (also
    capped) — pinned by the three disconnected-graph goldens.

networkx is imported inside the methods that build, save or read a graph;
the node->Group CSV has the bytes of seekr_tpu's ``to_csv`` without pandas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from seekr_tpu_torch.io.fast_csv import _quote
from seekr_tpu_torch.utils.adj import get_adj


class Partition:
    """Community partition result: ``membership`` list + ``modularity``.

    Mirrors the attribute surface the legacy tests read off the
    igraph/louvain partition object (test_graph.py:129-132).
    """

    def __init__(self, membership, modularity):
        self.membership = membership
        self.modularity = modularity

    def __repr__(self):  # pragma: no cover - debugging nicety
        return (f"Partition(n={len(self.membership)}, "
                f"n_comms={len(set(self.membership))}, "
                f"modularity={self.modularity:.6f})")


def _relabel_by_size(membership: np.ndarray) -> np.ndarray:
    """Relabel community ids largest-first; ties by first appearance."""
    ids, first_idx, sizes = np.unique(membership, return_index=True,
                                      return_counts=True)
    order = sorted(range(len(ids)), key=lambda i: (-sizes[i], first_idx[i]))
    remap = np.empty(int(ids.max()) + 1, dtype=np.int32)
    for new_id, old_pos in enumerate(order):
        remap[ids[old_pos]] = new_id
    return remap[membership]


def _unweighted_modularity(n_nodes: int, edges, membership) -> float:
    """Standard Newman modularity treating every edge as weight 1.

    Fully vectorized: per-community degree and internal-edge sums come
    from ``np.bincount`` (a per-community Python scan would be
    O(n_nodes * n_communities) at the 13k-node scale this package
    targets).
    """
    m = len(edges)
    if m == 0:
        return 0.0
    mem = np.asarray(membership, dtype=np.int64)
    e = np.asarray(edges, dtype=np.int64)
    deg = (np.bincount(e[:, 0], minlength=n_nodes)
           + np.bincount(e[:, 1], minlength=n_nodes))
    n_comms = int(mem.max()) + 1
    same = mem[e[:, 0]] == mem[e[:, 1]]
    internal = np.bincount(mem[e[:, 0]][same], minlength=n_comms)
    d_c = np.bincount(mem, weights=deg.astype(np.float64),
                      minlength=n_comms)
    return float(np.sum(internal / m - (d_c / (2.0 * m)) ** 2))


class Maker:
    """Build, save, and partition a community graph from an adjacency.

    Parameters
    ----------
    adj : adjacency as a ``LabeledMatrix`` (or any object with ``values`` and
        ``index``), an ndarray, or a path (``.npy``/labeled CSV)
    gml_path : where :meth:`save` writes the GML (and where
        :meth:`get_partition` reads it back)
    csv_path : where :meth:`make_gml_csv_files` writes the node->Group CSV
    threshold : entries strictly below this are zeroed (default 0 — the
        diagonal and negative similarities drop)
    gamma : resolution parameter of the weighted partition
    n_comms : cap on distinct group ids in :meth:`membership2attribute`
    seed : RNG seed for the partition engine
    """

    def __init__(self, adj=None, gml_path: str = "graph.gml",
                 csv_path: str = "graph.csv", threshold: float = 0,
                 gamma: float = 1.0, n_comms: int = 5,
                 seed: Optional[int] = None):
        self.adj = None if adj is None else get_adj(adj)
        self.gml_path = gml_path
        self.csv_path = csv_path
        self.threshold = threshold
        self.gamma = gamma
        self.n_comms = n_comms
        self.seed = seed
        self.graph = None
        self.main_sub = None
        self.partition: Optional[Partition] = None
        self._partition_nodes = None  # node list of the partitioned GML

    # -- graph construction --------------------------------------------------

    def _labeled(self) -> bool:
        return not isinstance(self.adj, np.ndarray)

    def _adj_values(self) -> np.ndarray:
        return self.adj.values if self._labeled() else self.adj

    def apply_threshold(self) -> None:
        """Zero sub-threshold entries and the diagonal, in place.

        The caller's labeled matrix or ndarray (the same object) mutates,
        preserving the legacy in-place contract (reference
        test_graph.py:46-52); a read-only array is copied first.
        """
        vals = self._adj_values()
        if not vals.flags.writeable:
            vals = vals.copy()
            if self._labeled():
                self.adj.values = vals
            else:
                self.adj = vals
        vals[vals < self.threshold] = 0
        np.fill_diagonal(vals, 0)

    def build(self, clear_adj: bool = True, main_sub: bool = True) -> None:
        """Threshold the adjacency and build the weighted networkx graph."""
        import networkx

        self.apply_threshold()
        vals = self._adj_values()
        if self._labeled():
            names = [str(n) for n in self.adj.index]
        else:
            names = [str(i) for i in range(vals.shape[0])]
        graph = networkx.Graph()
        graph.add_nodes_from(names)
        # strictly positive weights only (the documented contract): a
        # negative threshold would otherwise leave negative-r entries in
        # the adjacency, feeding negative-weight edges into a modularity
        # optimization that is undefined for them
        rows, cols = np.nonzero(np.triu(vals, k=1) > 0)
        graph.add_weighted_edges_from(
            (names[i], names[j], float(vals[i, j]))
            for i, j in zip(rows.tolist(), cols.tolist()))
        self.graph = graph
        if clear_adj:
            self.adj = None
        if main_sub:
            self.find_main_sub()

    def find_main_sub(self) -> None:
        """Largest connected component (first wins ties), node order kept."""
        import networkx

        largest = max(networkx.connected_components(self.graph), key=len)
        self.main_sub = self.graph.subgraph(
            [n for n in self.graph if n in largest])

    def save(self, main_sub: bool = False) -> None:
        """Write the graph (or its main component) to ``gml_path``."""
        import networkx

        graph = self.main_sub if main_sub else self.graph
        networkx.write_gml(graph, self.gml_path, stringizer=str)

    # -- partitioning --------------------------------------------------------

    def get_partition(self) -> Partition:
        """Partition the saved GML graph into communities.

        Reads ``gml_path`` back (legacy semantics: the partition engine
        consumed the written file), optimizes weighted modularity at
        resolution ``gamma`` with the native Leiden engine, relabels
        communities largest-first, and reports the unweighted Newman
        modularity of the result.
        """
        import networkx

        from seekr_tpu_torch import native

        graph = networkx.read_gml(self.gml_path)
        nodes = list(graph.nodes())
        self._partition_nodes = nodes
        index = {n: i for i, n in enumerate(nodes)}
        edges = [(index[u], index[v]) for u, v in graph.edges()]
        if edges:
            src = np.array([e[0] for e in edges], dtype=np.int64)
            dst = np.array([e[1] for e in edges], dtype=np.int64)
            weights = np.array(
                [graph.edges[u, v].get("weight", 1.0)
                 for u, v in graph.edges()], dtype=np.float64)
            membership = native.leiden(
                src, dst, weights, n_nodes=len(nodes),
                algo="RBConfigurationVertexPartition",
                resolution=self.gamma, seed=self.seed)
            membership = _relabel_by_size(np.asarray(membership))
        else:
            membership = np.arange(len(nodes), dtype=np.int32)
        modularity = _unweighted_modularity(len(nodes), edges, membership)
        self.partition = Partition([int(c) for c in membership], modularity)
        return self.partition

    def membership2attribute(self) -> dict:
        """Map every graph node to a group id capped at ``n_comms``.

        Partitioned nodes (the node set of the GML ``get_partition``
        read — ``main_sub`` in the standard pipeline) take their
        partition community BY NAME; each remaining connected component
        takes the next id. All ids are capped at ``n_comms``. Groups are
        also set as the ``"Group"`` node attribute on ``self.graph``.
        """
        import networkx

        if self.partition is None:
            self.get_partition()
        part_nodes = getattr(self, "_partition_nodes", None)
        if part_nodes is None:
            part_nodes = list(self.main_sub.nodes())
        if len(part_nodes) != len(self.partition.membership):
            raise ValueError(
                f"partition size ({len(self.partition.membership)}) does not "
                f"match its node list ({len(part_nodes)})")
        # mapping by name (not position against main_sub) keeps group
        # assignments correct when the partitioned GML was the full graph
        # or a stale file — a positional zip would silently pair the wrong
        # nodes with the wrong communities.  GML stringifies node names
        # (save() uses stringizer=str), so non-string nodes of a
        # hand-assigned graph are resolved through their str() form.
        by_str = {str(n): n for n in self.graph}
        resolved, unknown = [], []
        for n in part_nodes:
            if n in self.graph:
                resolved.append(n)
            elif n in by_str:
                resolved.append(by_str[n])
            else:
                unknown.append(n)
        if unknown:
            raise ValueError(
                f"partition was computed from {self.gml_path!r}, whose nodes "
                f"(e.g. {unknown[0]!r}) are not in the built graph — the GML "
                f"file is stale; call save() before get_partition()")
        name2group = {}
        for node, community in zip(resolved, self.partition.membership):
            name2group[node] = min(community, self.n_comms)
        next_id = len(set(self.partition.membership))
        covered = set(resolved)
        for component in networkx.connected_components(self.graph):
            if component <= covered:
                continue
            group = min(next_id, self.n_comms)
            for node in component:
                name2group[node] = group
            next_id += 1
        networkx.set_node_attributes(self.graph, name2group, "Group")
        return name2group

    # -- one-shot pipeline ---------------------------------------------------

    def make_gml_csv_files(self) -> dict:
        """Full legacy pipeline: build -> partition -> annotated GML + CSV.

        The final GML holds the whole graph with ``Group`` node
        attributes; the CSV is the node->Group table in graph node
        order (test_graph.py:176-187), in the bytes seekr_tpu's
        ``to_csv`` of that table writes.
        """
        self.build()
        self.save(main_sub=True)
        self.get_partition()
        name2group = self.membership2attribute()
        self.save()
        if self.csv_path:
            with open(self.csv_path, "w", newline="") as fh:
                fh.write(",Group\n")
                fh.writelines(f"{_quote(n)},{name2group[n]}\n" for n in self.graph)
        return name2group
