"""The port's community path (``graph.kmer_leiden``) against seekr_tpu's, on the
CPU, on a small planted corpus: 8 families of 12 transcripts, each member its
family's founder with 10% of its bases substituted, made from a seed.

Tolerances: the similarity within 1e-4 of seekr_tpu's (both float32 GEMMs, on
XLA and on torch); the same edge set but for pairs within 1e-4 of the cutoff;
the same partition up to relabeling.  The Gephi exporters are byte-equal to
seekr_tpu's pandas ``to_csv`` on the same matrix or edges.
"""

import importlib

import numpy as np
import pandas as pd
import pytest
import torch

from seekr_tpu_torch.io.fast_csv import LabeledMatrix
from seekr_tpu_torch.io.fasta import write_fasta

# the modules, not the functions of the same name that graph/__init__ exports
jax_leiden = importlib.import_module("seekr_tpu.graph.kmer_leiden")
leiden = importlib.import_module("seekr_tpu_torch.graph.kmer_leiden")

FAMILIES, MEMBERS, CUTOFF = 8, 12, 0.2


def planted_corpus(rng, families=FAMILIES, members=MEMBERS, rate=0.1):
    letters = np.array(list("AGTC"))
    names, seqs = [], []
    for f in range(families):
        founder = rng.integers(0, 4, size=int(rng.integers(300, 700)))
        for j in range(members):
            s = founder.copy()
            hit = rng.random(s.size) < rate
            s[hit] = rng.integers(0, 4, size=int(hit.sum()))
            names.append(f"f{f}_m{j}")
            seqs.append("".join(letters[s]))
    return names, seqs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from seekr_tpu_torch.models.counter import KmerCounter

    root = tmp_path_factory.mktemp("leiden")
    names, seqs = planted_corpus(np.random.default_rng(0))
    write_fasta(str(root / "c.fa"), names, seqs)
    vectors = {}
    for k in (3, 4):
        raw = KmerCounter(str(root / "c.fa"), k=k, mean=False, std=False, silent=True,
                          device="cpu").get_counts()
        np.save(root / f"mean{k}.npy", raw.mean(axis=0))
        np.save(root / f"std{k}.npy", raw.std(axis=0))
        vectors[k] = (str(root / f"mean{k}.npy"), str(root / f"std{k}.npy"))
    return root, str(root / "c.fa"), vectors


def same_partition(a, b) -> bool:
    """Equal up to relabeling: the label pairs form a bijection."""
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(a)) == len(set(b))


def edge_set(src, dst):
    return set(zip(np.asarray(src).tolist(), np.asarray(dst).tolist()))


@pytest.mark.parametrize("k", [3, 4])
def test_similarity_graph_and_partition_match(corpus, k):
    _, fa, (mean, std) = corpus[0], corpus[1], corpus[2][k]
    got = leiden.similarity_graph(fa, mean, std, k, CUTOFF, device="cpu")
    want = jax_leiden.similarity_graph(fa, mean, std, k, CUTOFF)
    assert isinstance(got, LabeledMatrix) and got.values.dtype == np.float32
    assert got.index == list(want.index) == got.columns
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-4)
    # the same edges but within 1e-4 of the cutoff, where ulps may decide
    vals = want.values
    clear = np.abs(vals - CUTOFF) > 1e-4
    assert np.array_equal((got.values > 0) & clear, (vals > 0) & clear)
    got_m = leiden.leiden_membership(got, setseed=True)
    want_m = jax_leiden.leiden_membership(want, setseed=True)
    assert same_partition(got_m, want_m)
    if k == 4:  # 256 k-mer columns separate the planted families exactly
        assert same_partition(got_m, np.repeat(np.arange(FAMILIES), MEMBERS))


@pytest.mark.parametrize("k", [3, 4])
def test_streamed_edges_match_dense(corpus, k):
    from seekr_tpu_torch.models.counter import KmerCounter

    fa, (mean, std) = corpus[1], corpus[2][k]
    counts = KmerCounter(fa, mean=mean, std=std, k=k, silent=True,
                         device="cpu").get_counts_device()
    src, dst, w = leiden.sparse_similarity_edges(counts, CUTOFF, block_rows=40,
                                                 device="cpu")
    dense = leiden.similarity_graph(fa, mean, std, k, CUTOFF, device="cpu").values
    near = np.abs(dense - CUTOFF) <= 1e-4
    ds, dd = np.nonzero(np.triu(dense > 0, k=1) & ~near)
    assert edge_set(ds, dd) == edge_set(src, dst) - edge_set(*np.nonzero(near))
    np.testing.assert_allclose(w, dense[src, dst], rtol=0, atol=1e-6)
    assert (src < dst).all() and w.dtype == np.float32


@pytest.mark.parametrize("stream", [False, True], ids=["dense", "streamed"])
def test_kmer_leiden_matches(corpus, stream):
    root, fa, (mean, std) = corpus[0], corpus[1], corpus[2][4]
    got = leiden.kmer_leiden(fa, mean, std, 4, pearsoncutoff=CUTOFF, setseed=True,
                             csvfile=str(root / f"t{stream}"), stream=stream, device="cpu")
    want = jax_leiden.kmer_leiden(fa, mean, std, 4, pearsoncutoff=CUTOFF, setseed=True,
                                  csvfile=str(root / f"j{stream}"), stream=stream)
    assert got.dtype == np.int32 and same_partition(got, want)
    # two seeded runs: the same membership
    again = leiden.kmer_leiden(fa, mean, std, 4, pearsoncutoff=CUTOFF, setseed=True,
                               stream=stream, device="cpu")
    np.testing.assert_array_equal(got, again)
    for part in ("nodes", "edges"):
        t = pd.read_csv(root / f"t{stream}_{part}_leiden.csv")
        j = pd.read_csv(root / f"j{stream}_{part}_leiden.csv")
        assert list(t.columns) == list(j.columns) and len(t) == len(j)
        if part == "edges":  # weights are the two GEMMs' values
            assert t[["Source", "Target"]].equals(j[["Source", "Target"]])
            np.testing.assert_allclose(t["Weight"], j["Weight"], rtol=0, atol=1e-4)
        elif np.array_equal(got, want):
            assert t.equals(j)


def similarity_with_nan(rng, m=30):
    sim = rng.uniform(-0.3, 1.0, size=(m, m)).astype(np.float32)
    sim = np.triu(sim, 1) + np.triu(sim, 1).T
    sim[4, :] = sim[:, 4] = np.nan  # a row whose similarity is NaN
    sim[sim < CUTOFF] = 0
    np.fill_diagonal(sim, 0)
    return sim


def test_gephi_exports_byte_equal(tmp_path):
    rng = np.random.default_rng(1)
    sim = similarity_with_nan(rng)
    names = [f"t{i}" for i in range(len(sim))]
    names[2], names[5], names[7] = "a,b", 'say "x"', "12"
    membership = rng.integers(0, 5, size=len(sim)).astype(np.int32)
    leiden.export_gephi_csv(LabeledMatrix(sim, names, names), membership, str(tmp_path / "t"))
    jax_leiden.export_gephi_csv(pd.DataFrame(sim, index=names, columns=names), membership,
                                str(tmp_path / "j"))
    src, dst = np.nonzero(np.triu(sim > 0, k=1))
    w = sim[src, dst]
    leiden.export_gephi_csv_edges(names, membership, src, dst, w, str(tmp_path / "ts"))
    jax_leiden.export_gephi_csv_edges(names, membership, src, dst, w, str(tmp_path / "js"))
    for ours, theirs in (("t", "j"), ("ts", "js")):
        for part in ("nodes", "edges"):
            got = (tmp_path / f"{ours}_{part}_leiden.csv").read_bytes()
            assert got == (tmp_path / f"{theirs}_{part}_leiden.csv").read_bytes()
    # the NaN row's cells are dropped from the melt
    melt = pd.read_csv(tmp_path / "t_edges_leiden.csv")
    assert len(melt) == (len(sim) - 1) * (len(sim) - 2) // 2
    # an empty edge set writes the header alone
    leiden.export_gephi_csv_edges(names, membership, [], [], np.empty(0, np.float32),
                                  str(tmp_path / "e"))
    assert (tmp_path / "e_edges_leiden.csv").read_text() == "Source,Target,Weight\n"


def test_leiden_membership_of_a_matrix_matches(tmp_path):
    sim = similarity_with_nan(np.random.default_rng(2))
    names = [f"t{i}" for i in range(len(sim))]
    for algo in ("SignificanceVertexPartition", "CPMVertexPartition"):
        got = leiden.leiden_membership(LabeledMatrix(sim, names, names), algo=algo,
                                       rs=0.4, setseed=True)
        want = jax_leiden.leiden_membership(pd.DataFrame(sim), algo=algo, rs=0.4,
                                            setseed=True)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="algo must be one of"):
        leiden.leiden_membership(sim, algo="NoSuchPartition")


def test_what_raises_and_what_returns_none(corpus, capsys, monkeypatch):
    fa, (mean, std) = corpus[1], corpus[2][3]
    # streamed, the plot is skipped with seekr_tpu's message and nothing is drawn
    leiden.kmer_leiden(fa, mean, std, 3, stream=True, plotname="net", device="cpu")
    assert "skips the spring-layout plot (net.pdf not written)" in capsys.readouterr().out
    # a mesh of cards needs that many cards; the CPU mesh needs device="cpu"
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="requested 2 devices"):
            leiden.kmer_leiden(fa, mean, std, 3, data_parallel=2, device="cuda")
    # norm vectors of another k: printed and None, as seekr_tpu
    assert leiden.kmer_leiden(fa, mean, std, 4, device="cpu") is None
    assert "No Leiden community is calculated" in capsys.readouterr().out


def test_mesh_matches_one_device_and_seekr_tpu(corpus):
    """``data_parallel`` on the port's CPU mesh: the streamed edges (what
    ``data_parallel`` implies) and the dense matrix (``stream=False``) as on one
    device, the same families as seekr_tpu's mesh run."""
    from seekr_tpu_torch.models.counter import KmerCounter
    from seekr_tpu_torch.parallel.mesh import make_mesh

    k = 4
    fa, (mean, std) = corpus[1], corpus[2][k]
    alone = leiden.kmer_leiden(fa, mean, std, k, pearsoncutoff=CUTOFF, setseed=True,
                               stream=True, device="cpu")
    got = leiden.kmer_leiden(fa, mean, std, k, pearsoncutoff=CUTOFF, setseed=True,
                             data_parallel=4, device="cpu")
    want = jax_leiden.kmer_leiden(fa, mean, std, k, pearsoncutoff=CUTOFF, setseed=True,
                                  data_parallel=4)
    assert np.array_equal(got, alone) and same_partition(got, want)
    assert len(set(got.tolist())) == FAMILIES

    mesh = make_mesh([torch.device("cpu")] * 4)
    counts = KmerCounter(fa, mean=mean, std=std, k=k, silent=True,
                         device="cpu").get_counts_device()
    one = leiden.sparse_similarity_edges(counts, CUTOFF, device="cpu")
    sharded = leiden.sparse_similarity_edges(counts, CUTOFF, mesh=mesh, block_rows=7)
    assert edge_set(*sharded[:2]) == edge_set(*one[:2])
    np.testing.assert_allclose(sharded[2], one[2], rtol=0, atol=1e-6)
    dense = leiden.similarity_graph(fa, mean, std, k, CUTOFF, mesh=mesh, device="cpu")
    plain = leiden.similarity_graph(fa, mean, std, k, CUTOFF, device="cpu")
    assert np.array_equal(dense.values, dense.values.T)  # mirrored
    np.testing.assert_allclose(dense.values, plain.values, rtol=0, atol=1e-6)
    assert dense.index == plain.index
