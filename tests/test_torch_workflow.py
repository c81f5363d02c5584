"""The port's one-shot workflow (``models/workflow.run_workflow``) and its
``pipeline`` command against seekr_tpu's, on the CPU.

Queries ``tests/fixtures/ldseq.fa`` (21 transcripts), background
``tests/fixtures/seqs1.fa`` (111, so 6,105 null values, subsampled to 500 by a
seeded draw).  Tolerances: norm vectors rtol 1e-6; counts atol 1e-5; r atol
1e-4 (XLA's and torch's float32 GEMMs differ in the last bits); the null
sample the same draw within 1e-4; p-values equal except in cells whose r lies
within 1e-5 of a null value; Leiden membership equal.  The artifact writers
are held byte for byte on one matrix: the port's on seekr_tpu's results give
seekr_tpu's files.
"""

import os

import numpy as np
import pandas as pd
import pytest

from seekr_tpu.models.workflow import run_workflow as jax_run_workflow
from seekr_tpu_torch import cli
from seekr_tpu_torch.io.fast_csv import LabeledMatrix, read_labeled_csv, write_labeled_csv
from seekr_tpu_torch.models.counter import KmerCounter
from seekr_tpu_torch.models.workflow import _write_communities, run_workflow

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
QUERIES = os.path.join(FIXTURES, "ldseq.fa")
BACKGROUND = os.path.join(FIXTURES, "seqs1.fa")
RUN = dict(subset_size=500, seed=7, leiden=True, leiden_cutoff=0.1)


def near_null(r, null, tol=1e-5):
    b = np.sort(np.asarray(null, dtype=np.float64))
    r = np.asarray(r, dtype=np.float64)
    return np.searchsorted(b, r + tol, side="right") > np.searchsorted(b, r - tol, side="left")


@pytest.fixture(scope="module", params=[2, 3], ids=["k2", "k3"])
def both_runs(request, tmp_path_factory):
    k = request.param
    out = tmp_path_factory.mktemp(f"wf{k}")
    jax = jax_run_workflow(QUERIES, background=BACKGROUND, k=k, outdir=str(out / "j"), **RUN)
    port = run_workflow(QUERIES, background=BACKGROUND, k=k, outdir=str(out / "t"),
                        device="cpu", **RUN)
    return k, out, jax, port


def test_matches_seekr_tpu(both_runs):
    k, _, jax, port = both_runs
    np.testing.assert_allclose(port["mean"], np.asarray(jax["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port["std"], np.asarray(jax["std"]), rtol=1e-6)
    np.testing.assert_allclose(port["counts1"], np.asarray(jax["counts1"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port["pearson"], np.asarray(jax["pearson"]), rtol=0, atol=1e-4)
    assert port["counts2"] is port["counts1"]
    # the null: the same seeded draw from the background's triangle
    assert port["null_sample"].shape == (500,)
    np.testing.assert_allclose(port["null_sample"], np.asarray(jax["null_sample"]),
                               rtol=0, atol=1e-4)
    got, want = port["pvals"], jax["pvals"]
    assert got.index == list(want.index) and got.columns == list(want.columns)
    assert got.values.dtype == want.to_numpy().dtype == np.float32
    ties = near_null(port["pearson"], port["null_sample"])
    assert ties.mean() < 0.5
    assert np.array_equal(got.values[~ties], want.to_numpy()[~ties])
    assert np.array_equal(port["communities"], jax["communities"])


def test_adjusted_is_the_port_correction_of_its_pvals(both_runs):
    from seekr_tpu_torch.stats.adj_pval import adj_pval

    _, _, _, port = both_runs
    adj = port["pvals_adjusted"]
    want = adj_pval(port["pvals"], "fdr_bh")
    np.testing.assert_array_equal(adj.values, want.values)
    assert np.isnan(np.diag(adj.values)).all()  # the self matrix: upper triangle only


def test_artifact_bytes_of_both_writers_on_one_matrix(both_runs, tmp_path):
    # the port's writers, given seekr_tpu's results, write seekr_tpu's files
    k, out, jax, port = both_runs
    headers = list(jax["pvals"].index)
    kmers = KmerCounter(k=k, device="cpu").kmers
    write_labeled_csv(tmp_path / "counts1.csv", np.asarray(jax["counts1"]), headers, kmers)
    write_labeled_csv(tmp_path / "pearson.csv", np.asarray(jax["pearson"]), headers, headers)
    for name in ("pvals", "pvals_adjusted"):
        frame = jax[name]
        LabeledMatrix(frame.to_numpy(), frame.index, frame.columns).to_csv(
            tmp_path / f"{name}.csv")
    _write_communities(tmp_path / "communities.csv", headers, jax["communities"])
    for name in ("counts1", "pearson", "pvals", "pvals_adjusted", "communities"):
        assert (tmp_path / f"{name}.csv").read_bytes() == \
            (out / "j" / f"{name}.csv").read_bytes(), name
    # and the port's own artifacts read back as its results
    t = out / "t"
    np.testing.assert_array_equal(np.load(t / f"mean_{k}mers.npy"), port["mean"])
    np.testing.assert_array_equal(read_labeled_csv(t / "pvals.csv", dtype=np.float32).values,
                                  port["pvals"].values)
    assert pd.read_csv(t / "communities.csv")["Community"].tolist() == \
        port["communities"].tolist()


def test_communities_csv_quotes_labels(tmp_path):
    _write_communities(tmp_path / "c.csv", ["a,b", 'q"x', "plain"], np.array([0, 1, 0]))
    pd.DataFrame({"Id": ["a,b", 'q"x', "plain"], "Community": [0, 1, 0]}).to_csv(
        tmp_path / "want.csv", index=False)
    assert (tmp_path / "c.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()


def test_pipeline_command_writes_the_api_artifacts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    api = run_workflow(QUERIES, background=BACKGROUND, k=2, outdir="api", device="cpu", **RUN)
    cli.main(["pipeline", QUERIES, "-b", BACKGROUND, "-k", "2", "-sbs", "500", "-sd", "7",
              "--leiden", "-lc", "0.1", "-o", "cli", "--device", "cpu"])
    for name in ("counts1.csv", "pearson.csv", "pvals.csv", "pvals_adjusted.csv",
                 "communities.csv", "mean_2mers.npy", "std_2mers.npy"):
        assert (tmp_path / "cli" / name).read_bytes() == (tmp_path / "api" / name).read_bytes()
    assert api["communities"] is not None


def test_cross_run_and_its_leiden_skip(tmp_path, capsys):
    res = run_workflow(QUERIES, seq2file=BACKGROUND, background=BACKGROUND, k=2,
                       outdir=str(tmp_path / "x"), subset_size=100, seed=1, leiden=True,
                       device="cpu")
    assert res["pearson"].shape == (21, 111) and res["communities"] is None
    assert "leiden stage skipped" in capsys.readouterr().out
    assert read_labeled_csv(tmp_path / "x" / "counts2.csv").shape == (111, 16)
    assert not (tmp_path / "x" / "communities.csv").exists()
    # the cross p-values are corrected as a full matrix
    assert not np.isnan(res["pvals_adjusted"].values).any()


def test_cross_run_matches_seekr_tpu(tmp_path):
    kwargs = dict(seq2file=BACKGROUND, background=BACKGROUND, k=3, subset_size=400, seed=3)
    jax = jax_run_workflow(QUERIES, outdir=str(tmp_path / "j"), **kwargs)
    port = run_workflow(QUERIES, outdir=str(tmp_path / "t"), device="cpu", **kwargs)
    np.testing.assert_allclose(port["counts2"], np.asarray(jax["counts2"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port["pearson"], np.asarray(jax["pearson"]), rtol=0, atol=1e-4)
    ties = near_null(port["pearson"], port["null_sample"])
    assert np.array_equal(port["pvals"].values[~ties], jax["pvals"].to_numpy()[~ties])


def test_realpath_spelling_is_a_self_comparison(tmp_path):
    alt = os.path.join(os.path.dirname(QUERIES), ".", os.path.basename(QUERIES))
    res = run_workflow(QUERIES, seq2file=alt, background=BACKGROUND, k=2,
                       outdir=str(tmp_path / "alt"), subset_size=10 ** 9, leiden=True,
                       leiden_cutoff=0.1, device="cpu")
    assert res["communities"] is not None and res["counts2"] is res["counts1"]


def test_what_raises(tmp_path):
    with pytest.raises(ValueError, match="background"):
        run_workflow(QUERIES, device="cpu")
    with pytest.raises(ValueError, match="leiden_algo must be one of"):
        run_workflow(QUERIES, background=BACKGROUND, k=2, outdir=str(tmp_path / "never"),
                     leiden=True, leiden_algo="RBERVertexPartion", device="cpu")
    assert not (tmp_path / "never").exists()  # refused before any stage
    # the multi-host arguments come with slice 9 (a mesh in one process runs)
    for kwargs in ({"coordinator": "h:1"}, {"num_processes": 2, "process_id": 0},
                   {"data_parallel": 2, "coordinator": "h:1"},
                   {"data_parallel": 2, "kmer_parallel": 2, "num_processes": 4}):
        with pytest.raises(NotImplementedError, match="slice 9"):
            run_workflow(QUERIES, background=BACKGROUND, k=2, outdir=str(tmp_path / "m"),
                         device="cpu", **kwargs)
    assert not (tmp_path / "m").exists()


@pytest.mark.parametrize("mesh", [{"data_parallel": 4}, {"data_parallel": 2, "kmer_parallel": 2}],
                         ids=["dp4", "dp2-kp2"])
def test_mesh_run_matches_one_device_and_seekr_tpu(both_runs, mesh):
    # self (with Leiden) and cross; the port's CPU mesh against its one-device
    # run and seekr_tpu's mesh on its virtual devices
    k, out, jax, port = both_runs
    name = "-".join(f"{key}{value}" for key, value in mesh.items())
    got = run_workflow(QUERIES, background=BACKGROUND, k=k, outdir=str(out / f"t_{name}"),
                       device="cpu", **RUN, **mesh)
    ref = jax_run_workflow(QUERIES, background=BACKGROUND, k=k,
                           outdir=str(out / f"j_{name}"), **RUN, **mesh)
    np.testing.assert_allclose(got["pearson"], port["pearson"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["null_sample"], port["null_sample"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["pearson"], np.asarray(ref["pearson"]), rtol=0, atol=1e-4)
    assert np.array_equal(got["pearson"], got["pearson"].T)  # mirrored
    ties = near_null(got["pearson"], got["null_sample"])
    assert np.array_equal(got["pvals"].values[~ties], ref["pvals"].to_numpy()[~ties])
    assert np.array_equal(got["communities"], port["communities"])
    assert np.array_equal(got["communities"], ref["communities"])
    cross = run_workflow(QUERIES, seq2file=BACKGROUND, background=BACKGROUND, k=k,
                         outdir=str(out / f"x_{name}"), subset_size=400, seed=3,
                         device="cpu", **mesh)
    alone = run_workflow(QUERIES, seq2file=BACKGROUND, background=BACKGROUND, k=k,
                         outdir=str(out / f"x1_{name}"), subset_size=400, seed=3,
                         device="cpu")
    np.testing.assert_allclose(cross["pearson"], alone["pearson"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(cross["pvals"].values, alone["pvals"].values, rtol=0, atol=1e-6)


def test_pipeline_command_on_a_mesh(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["pipeline", QUERIES, "-b", BACKGROUND, "-k", "2", "-sbs", "500", "-sd", "7",
            "--leiden", "-lc", "0.1", "--device", "cpu"]
    cli.main(base + ["-o", "one"])
    cli.main(base + ["-o", "mesh", "-dp", "2", "-kp", "2"])
    for name in ("counts1.csv", "communities.csv", "mean_2mers.npy", "std_2mers.npy"):
        assert (tmp_path / "mesh" / name).read_bytes() == (tmp_path / "one" / name).read_bytes()
    np.testing.assert_allclose(read_labeled_csv(tmp_path / "mesh" / "pearson.csv").values,
                               read_labeled_csv(tmp_path / "one" / "pearson.csv").values,
                               rtol=0, atol=1e-6)
