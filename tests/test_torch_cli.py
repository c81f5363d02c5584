"""The port's command line against seekr_tpu's, on the CPU (``--device cpu``).

Tolerances: raw counts (``-uc -us -l Log2.none``) byte-equal; normalized
counts rtol 1e-4 / atol 1e-5; Pearson 1e-4; fitted parameters 1e-4 relative;
empirical p-values equal except in cells whose r lies within 1e-5 of a
background value, fitted ones within 1e-4; adj_pval on the same p-value file
byte-equal.  Every test runs in its own working directory: find_dist and
norm_vectors write their .npy artifacts there.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from seekr_tpu import cli as jax_cli
from seekr_tpu_torch import cli
from seekr_tpu_torch.io.fast_csv import read_labeled_csv
from seekr_tpu_torch.io.fasta import write_fasta
from seekr_tpu_torch.models.counter import KmerCounter
from seekr_tpu_torch.models.pearson import pearson

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def random_fasta(path, m, seed):
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(150, 900))))
            for _ in range(m)]
    write_fasta(str(path), [f"s{seed}_{i}" for i in range(m)], seqs)
    return str(path)


@pytest.fixture
def work(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def both(args):
    """Run one command through seekr_tpu's CLI into j_* names and the port's
    into t_* names (``{out}`` in ``args`` is the output stem)."""
    jax_cli.main([a.replace("{out}", "j") for a in args])
    cli.main([a.replace("{out}", "t") for a in args] + CPU)


def test_raw_counts_byte_equal(example_fa, work):
    both(["kmer_counts", example_fa, "-o", "{out}.csv", "-k", "3", "-uc", "-us",
          "-l", "Log2.none"])
    assert (work / "t.csv").read_bytes() == (work / "j.csv").read_bytes()


@pytest.mark.parametrize("flags", [[], ["-b", "-rl"], ["-rl"], ["-l", "Log2.pre"]],
                         ids=["labeled", "npy", "raw", "log2-pre"])
def test_kmer_counts_forms(example_fa, work, flags):
    out = "{out}.npy" if "-b" in flags else "{out}.csv"
    both(["kmer_counts", example_fa, "-o", out, "-k", "2"] + flags)
    if "-b" in flags:
        got, want = np.load("t.npy"), np.load("j.npy")
    elif "-rl" in flags:
        got, want = np.loadtxt("t.csv", delimiter=","), np.loadtxt("j.csv", delimiter=",")
    else:
        t, j = read_labeled_csv("t.csv"), pd.read_csv("j.csv", index_col=0)
        assert t.index == list(j.index) and t.columns == list(j.columns)
        got, want = t.values, j.to_numpy()
    assert got.shape == want.shape == (5, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_norm_vectors(example_fa, work):
    both(["norm_vectors", example_fa, "-k", "2", "-mv", "{out}_mean.npy",
          "-sv", "{out}_std.npy", "-l", "Log2.none"])
    for name in ("mean", "std"):
        np.testing.assert_allclose(np.load(f"t_{name}.npy"), np.load(f"j_{name}.npy"),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("binary", [False, True], ids=["csv", "npy"])
def test_pearson(example_fa, work, binary):
    fa2 = random_fasta(work / "b.fa", 7, 4)
    ext = ".npy" if binary else ".csv"
    flags = ["-b", "-rl"] if binary else []
    for fa, stem in ((example_fa, "c1"), (fa2, "c2")):
        jax_cli.main(["kmer_counts", fa, "-o", stem + ext, "-k", "2"] + flags)
    both(["pearson", "c1" + ext, "c2" + ext, "-o", "{out}" + ext]
         + (["-bi", "-bo"] if binary else []))
    if binary:
        got, want = np.load("t.npy"), np.load("j.npy")
    else:
        t, j = read_labeled_csv("t.csv"), pd.read_csv("j.csv", index_col=0)
        assert t.index == list(j.index) and t.columns == list(j.columns)
        got, want = t.values, j.to_numpy()
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_stats_chain(work, capsys):
    bkg = random_fasta(work / "bkg.fa", 60, 1)
    q = random_fasta(work / "q.fa", 12, 2)
    t = random_fasta(work / "t.fa", 25, 3)

    # find_dist: fitted, then the raw subsample (the empirical background)
    fit = ["find_dist", bkg, "-k", "3", "-fm", "-mdl", "norm,expon,rayleigh", "-o", "{out}_fit"]
    np.random.seed(0)
    jax_cli.main([a.replace("{out}", "j") for a in fit])
    np.random.seed(0)
    cli.main([a.replace("{out}", "t") for a in fit] + CPU)
    got, want = cli.parse_fitres_csv("t_fit.csv", "distribution"), \
        jax_cli.parse_fitres_csv("j_fit.csv", "distribution")
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[2], w[2], rtol=1e-4)
    np.random.seed(1)
    cli.main(["find_dist", bkg, "-k", "3", "-sbt", "-sbs", "600", "-o", "t_bkg"] + CPU)
    np.random.seed(1)
    jax_cli.main(["find_dist", bkg, "-k", "3", "-sbt", "-sbs", "600", "-o", "j_bkg"])
    np.testing.assert_allclose(np.loadtxt("t_bkg.csv", delimiter=","),
                               np.loadtxt("j_bkg.csv", delimiter=","), rtol=0, atol=1e-4)

    # find_pval on the same vectors and backgrounds (seekr_tpu's artifacts)
    vectors = ["bkg_mean_3mers.npy", "bkg_std_3mers.npy"]
    both(["find_pval", q, t, *vectors, "3", "j_fit.csv", "-bf", "2", "-o", "{out}_pfit"])
    got, want = read_labeled_csv("t_pfit.csv"), pd.read_csv("j_pfit.csv", index_col=0)
    assert got.index == list(want.index) and got.columns == list(want.columns)
    np.testing.assert_allclose(got.values, want.to_numpy(), rtol=0, atol=1e-4)

    both(["find_pval", q, t, *vectors, "3", "j_bkg.csv", "-ft", "npy", "-o", "{out}_pemp"])
    got, want = read_labeled_csv("t_pemp.csv").values, pd.read_csv("j_pemp.csv",
                                                                  index_col=0).to_numpy()
    background = np.sort(np.loadtxt("j_bkg.csv", delimiter=","))
    counts = [KmerCounter(f, mean=vectors[0], std=vectors[1], k=3, silent=True,
                          device="cpu").get_counts() for f in (q, t)]
    r = pearson(*counts, device="cpu").astype(np.float64)
    ties = (np.searchsorted(background, r + 1e-5, side="right")
            > np.searchsorted(background, r - 1e-5, side="left"))
    assert np.array_equal(got[~ties], want[~ties])

    # adj_pval on one p-value file: byte-equal output, both paths
    both(["find_pval", t, t, *vectors, "3", "j_fit.csv", "-o", "{out}_pself"])
    for source in ("j_pfit.csv", "j_pself.csv"):
        both(["adj_pval", source, "fdr_bh", "-o", "{out}_adj"])
        assert (work / "t_adj.csv").read_bytes() == (work / "j_adj.csv").read_bytes()
    assert "is a symmetric matrix" in capsys.readouterr().out


@pytest.mark.parametrize("argv,slice_name", [
    (["adj_pval", "p.csv", "fdr_bh", "-bi"], "streamed adj_pval slice"),
    (["adj_pval", "p.csv", "fdr_bh", "-bo", "x.npy"], "streamed adj_pval slice"),
    (["adj_pval", "p.csv", "fdr_bh", "--symmetric", "yes"], "streamed adj_pval slice"),
    (["find_dist", "b.fa", "-dp", "2"], "multi-GPU slice"),
    (["find_dist", "b.fa", "-kp", "4"], "multi-GPU slice"),
    (["find_dist", "b.fa", "-fm", "-pf", "plot"], "viz slice"),
    (["find_pval", "a", "b", "m", "s", "3", "f", "-dp", "2"], "multi-GPU slice"),
])
def test_later_slices_are_refused(argv, slice_name, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + CPU)
    assert exc.value.code == 2
    assert slice_name in capsys.readouterr().err


@pytest.mark.parametrize("command", ["kmer_counts", "norm_vectors", "find_dist"])
def test_commands_need_a_card_unless_cpu_is_asked(example_fa, work, monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([command, example_fa])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["adj_pval", "p.csv", "fdr_bh"])


def test_dispatcher_help_and_unknown(capsys):
    assert cli.main([]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in cli.COMMANDS) and len(cli.COMMANDS) == 6
    assert cli.main(["nope"]) == 2
    with pytest.raises(SystemExit) as exc:
        cli.main(["kmer_counts"])  # a bare command prints its help
    assert exc.value.code == 0 and "--device" in capsys.readouterr().out


def test_module_entry_points(example_fa, work):
    proc = subprocess.run([sys.executable, "-m", "seekr_tpu_torch", "kmer_counts",
                           example_fa, "-o", "c.npy", "-b", "-rl", "-k", "2", "--device", "cpu"],
                          cwd=work, capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert np.load(work / "c.npy").shape == (5, 16)
    proc = subprocess.run([sys.executable, "-m", "seekr_tpu_torch.cli"], cwd=work,
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0 and "find_pval" in proc.stdout
