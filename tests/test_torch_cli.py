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


@pytest.mark.parametrize("argv,want", [
    (["--coordinator", "h:1"], {"coordinator": "h:1"}),
    (["--num_processes", "2"], {"num_processes": 2}),
    (["--process_id", "0"], {"process_id": 0}),
    (["-dp", "2", "--coordinator", "h:1", "--num_processes", "2", "--process_id", "0"],
     {"data_parallel": 2, "coordinator": "h:1", "num_processes": 2, "process_id": 0}),
], ids=["coordinator", "num_processes", "process_id", "all"])
def test_pipeline_passes_the_multi_host_flags(argv, want, monkeypatch):
    from seekr_tpu_torch.models import workflow

    seen = {}
    monkeypatch.setattr(workflow, "run_workflow", lambda *a, **kw: seen.update(kw))
    cli.main(["pipeline", "q.fa", "-b", "b.fa"] + argv + CPU)
    base = {"data_parallel": None, "coordinator": None, "num_processes": None,
            "process_id": None}
    assert {key: seen[key] for key in base} == {**base, **want}


def test_serve_num_processes_without_dp_is_seekr_tpus_error(capsys):
    # refused before any rendezvous (seekr_tpu/cli.py:546-555)
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "m.npy", "s.npy", "-t", "t.fa", "--num_processes", "2",
                  "--coordinator", "127.0.0.1:1"] + CPU)
    assert exc.value.code == 2
    assert ("--num_processes > 1 requires -dp N covering all devices (a multi-host "
            "serve must shard the corpus over one global mesh)") in capsys.readouterr().err


def test_pipeline_across_two_processes_writes_on_process_0_only(tmp_path):
    """``pipeline -dp 2 --num_processes 2`` in two processes (gloo on
    127.0.0.1, a CPU shard each), each in a working directory of its own: only
    process 0 writes, and its artifacts are byte-equal to one process holding
    the same (2, 1) mesh."""
    import socket

    q = random_fasta(tmp_path / "q.fa", 9, 41)
    b = random_fasta(tmp_path / "b.fa", 30, 42)
    args = ["pipeline", q, "-b", b, "-k", "3", "-sd", "0", "-dp", "2"] + CPU
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dirs = [tmp_path / f"p{pid}" for pid in range(2)]
    procs = []
    for pid, cwd in enumerate(dirs):
        cwd.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "seekr_tpu_torch.cli"] + args
            + ["-o", "out", "--num_processes", "2", "--process_id", str(pid),
               "--coordinator", f"127.0.0.1:{port}"],
            cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    assert not (dirs[1] / "out").exists()
    (tmp_path / "one").mkdir()
    cli.main(args + ["-o", str(tmp_path / "one" / "out")])
    written = sorted(f.name for f in (dirs[0] / "out").iterdir())
    assert written == sorted(f.name for f in (tmp_path / "one" / "out").iterdir())
    assert "pvals_adjusted.csv" in written
    for name in written:
        assert (dirs[0] / "out" / name).read_bytes() == \
            (tmp_path / "one" / "out" / name).read_bytes(), name


@pytest.mark.parametrize("command", ["kmer_counts", "norm_vectors", "find_dist"])
def test_commands_need_a_card_unless_cpu_is_asked(example_fa, work, monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([command, example_fa])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["adj_pval", "p.csv", "fdr_bh"])


@pytest.mark.parametrize("stream", ["off", "on", "mesh"])
def test_kmer_leiden_files_match(work, stream):
    # 5 families of 8: each member its founder with 10% of its bases substituted
    rng = np.random.default_rng(11)
    letters = np.array(list("AGTC"))
    names, seqs = [], []
    for f in range(5):
        founder = rng.integers(0, 4, size=int(rng.integers(300, 700)))
        for j in range(8):
            s = founder.copy()
            hit = rng.random(s.size) < 0.1
            s[hit] = rng.integers(0, 4, size=int(hit.sum()))
            names.append(f"f{f},{j}" if j == 3 else f"f{f}_{j}")
            seqs.append("".join(letters[s]))
    write_fasta("c.fa", names, seqs)
    cli.main(["norm_vectors", "c.fa", "-k", "4", "-mv", "mean.npy", "-sv", "std.npy"] + CPU)
    # -dp: a mesh of 4 (seekr_tpu's virtual devices, the port's CPU shards),
    # which implies the streamed edges
    flags = ["-dp", "4"] if stream == "mesh" else ["--stream", stream]
    both(["kmer_leiden", "c.fa", "mean.npy", "std.npy", "4", "-pco", "0.2", "-sd",
          "-cf", "{out}"] + flags)
    assert (work / "t_nodes_leiden.csv").read_bytes() == (work / "j_nodes_leiden.csv").read_bytes()
    t, j = pd.read_csv("t_edges_leiden.csv"), pd.read_csv("j_edges_leiden.csv")
    assert t[["Source", "Target"]].equals(j[["Source", "Target"]]) and len(t) > 0
    # the weights are the two float32 GEMMs' values, XLA's and torch's
    np.testing.assert_allclose(t["Weight"], j["Weight"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("mesh", [["-dp", "4"], ["-dp", "2", "-kp", "2"], ["-kp", "4"]],
                         ids=["dp4", "dp2-kp2", "kp4"])
def test_find_dist_on_a_mesh(work, mesh):
    bkg = random_fasta(work / "bkg.fa", 40, 1)
    argv = ["find_dist", bkg, "-k", "3", "-sbt", "-sbs", "300", "-o", "{out}"]
    for stem, flags in (("one", []), ("mesh", mesh)):
        np.random.seed(1)
        cli.main([a.replace("{out}", stem) for a in argv] + flags + CPU)
    np.random.seed(1)
    jax_cli.main([a.replace("{out}", "jax") for a in argv] + mesh)
    got = np.loadtxt("mesh.csv", delimiter=",")
    np.testing.assert_allclose(got, np.loadtxt("one.csv", delimiter=","), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.loadtxt("jax.csv", delimiter=","), rtol=0, atol=1e-4)


@pytest.mark.parametrize("stream", ["off", "on"])
def test_find_pval_on_a_mesh(work, stream):
    bkg, q, t = (random_fasta(work / f"{n}.fa", m, s)
                 for n, m, s in (("bkg", 30, 1), ("q", 5, 2), ("t", 9, 3)))
    cli.main(["norm_vectors", bkg, "-k", "3", "-mv", "m.npy", "-sv", "s.npy"] + CPU)
    (work / "fit.csv").write_text('distribution,D,params\nnorm,0.01,"(0.0, 0.25)"\n')
    argv = ["find_pval", q, t, "m.npy", "s.npy", "3", "fit.csv", "--stream", stream,
            "-bo", "{out}.npy"]
    cli.main([a.replace("{out}", "one") for a in argv] + CPU)
    both([a.replace("{out}", "{out}_mesh") for a in argv] + ["-dp", "2"])
    got = np.load("t_mesh.npy")
    np.testing.assert_allclose(got, np.load("one.npy"), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.load("j_mesh.npy"), rtol=0, atol=1e-4)


def test_mesh_needs_enough_cards(work, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    bkg = random_fasta(work / "bkg.fa", 10, 1)
    with pytest.raises(ValueError, match=r"requested 4 devices \(data_parallel=4 x "
                                         r"kmer_parallel=1\), have 1"):
        cli.main(["find_dist", bkg, "-k", "3", "-dp", "4", "--device", "cuda"])


def test_dispatcher_help_and_unknown(capsys):
    assert cli.main([]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in cli.COMMANDS) and len(cli.COMMANDS) == 26
    assert list(cli.COMMANDS) == list(jax_cli.COMMANDS)
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


# -- slice 7: the plots, graph and help ----------------------------------------

def recorded(monkeypatch, target, name, pick):
    """Patch ``target.name`` to record ``pick(args, kwargs)`` of every call."""
    calls = []
    original = getattr(target, name)

    def recorder(*args, **kwargs):
        calls.append(pick(args, kwargs))
        return original(*args, **kwargs)

    monkeypatch.setattr(target, name, recorder)
    return calls


def first_or_data(args, kwargs):
    return kwargs.get("data", args[0] if args else None)


def same(got, want):
    """Equal drawing data: arrays within 1e-9 relative (a CSV read by the port's
    reader and by pandas' parser may differ in the last bit), long-form columns
    with their values within 1e-4, anything else equal."""
    if isinstance(want, pd.DataFrame):
        return (list(got["Sample"]) == list(want["Sample"])
                and list(got["Kword"]) == list(want["Kword"])
                and np.allclose(np.asarray(got["Value"], np.float64),
                                want["Value"].to_numpy(np.float64), rtol=1e-4, atol=1e-4))
    if isinstance(want, np.ndarray):
        return np.allclose(got, want, rtol=1e-9, atol=1e-12, equal_nan=True)
    return got == want


@pytest.fixture
def plot_inputs(example_fa, work):
    import matplotlib

    matplotlib.use("Agg")
    raw = KmerCounter(example_fa, k=2, mean=False, std=False, silent=True,
                      device="cpu").get_counts()
    np.save("mean.npy", raw.mean(axis=0))
    np.save("std.npy", raw.std(axis=0))
    x = np.random.default_rng(8).normal(size=(7, 30))
    sim = np.corrcoef(x)
    names = [f"s{i}" for i in range(7)]
    pd.DataFrame(sim, names, names).to_csv("sim.csv")
    np.save("sim.npy", sim)
    return example_fa


@pytest.mark.parametrize("argv,target,pick", [
    (["kmer_heatmap", "sim.csv", "-1", "1", "-cl", "-o", "{out}", "-hf", "png", "-hd", "72"],
     ("seaborn", "heatmap"), first_or_data),
    (["kmer_dendrogram", "sim.csv", "-dd", "column", "-o", "{out}", "-pf", "png", "-d", "72"],
     ("scipy.cluster.hierarchy", "dendrogram"), first_or_data),
    (["kmer_count_barplot", "{fa}", "mean.npy", "std.npy", "2", "-sm", "descending", "-o",
      "{out}", "-pf", "png", "-d", "72"], ("seaborn", "barplot"), first_or_data),
    (["kmer_msd_barplot", "{fa}", "mean.npy", "std.npy", "2", "-ss", "sd", "-o", "{out}",
      "-pf", "png", "-d", "72"], ("seaborn", "barplot"), first_or_data),
    (["kmer_comp_textplot", "{fa}", "{fa}", "AAA,CG", "-cv", "#000000,#ff0000", "-wl", "40",
      "-o", "{out}", "-pf", "png", "-d", "72"], ("matplotlib.axes", "Axes.text"),
     lambda a, kw: (a[1:4], kw.get("color"), kw.get("weight"))),
    (["kmer_indi_textplot", "{fa}", "TTT", "-wl", "40", "-op", "{out}_", "-pf", "png", "-d",
      "72"], ("matplotlib.axes", "Axes.text"), lambda a, kw: (a[1:4], kw.get("color"))),
    (["visualize_distro", "sim.npy", "-o", "{out}", "-b", "12", "-pf", "png", "-d", "72"],
     ("matplotlib.axes", "Axes.set_title"), lambda a, kw: a[1]),
], ids=lambda v: v[0] if isinstance(v, list) else None)
def test_plot_commands_draw_the_same(plot_inputs, work, monkeypatch, capsys, argv, target,
                                     pick):
    import importlib

    module = importlib.import_module(target[0])
    owner, _, name = target[1].rpartition(".")
    calls = recorded(monkeypatch, getattr(module, owner) if owner else module, name, pick)
    argv = [a.replace("{fa}", plot_inputs) for a in argv]
    cli.main([a.replace("{out}", "t") for a in argv] + CPU)
    ours = len(calls)
    printed = capsys.readouterr().out
    jax_cli.main([a.replace("{out}", "j") for a in argv])
    assert printed == capsys.readouterr().out
    assert ours > 0 and len(calls) == 2 * ours
    assert all(same(g, w) for g, w in zip(calls[:ours], calls[ours:]))
    assert sorted(p.name[1:] for p in work.glob("t*.png")) == \
        sorted(p.name[1:] for p in work.glob("j*.png"))
    assert any(work.glob("t*.png"))


@pytest.mark.parametrize("adj", ["sim.npy", "sim.csv"])
def test_graph_writes_seekr_tpus_files(plot_inputs, work, adj):
    both(["graph", adj, "-g", "{out}.gml", "-c", "{out}.csv", "-t", "0.05", "-s", "0"])
    assert (work / "t.csv").read_bytes() == (work / "j.csv").read_bytes()
    if adj.endswith(".npy"):
        assert (work / "t.gml").read_bytes() == (work / "j.gml").read_bytes()
    else:  # pandas' CSV parser and the port's may differ in a weight's last bit
        import networkx

        got, want = networkx.read_gml("t.gml"), networkx.read_gml("j.gml")
        assert list(got.nodes(data=True)) == list(want.nodes(data=True))
        assert [e[:2] for e in got.edges(data=True)] == [e[:2] for e in want.edges(data=True)]
        np.testing.assert_allclose([w for *_, w in got.edges(data="weight")],
                                   [w for *_, w in want.edges(data="weight")], rtol=1e-15)


def test_fit_and_network_plots_are_written(work):
    bkg = random_fasta(work / "bkg.fa", 40, 4)
    cli.main(["find_dist", bkg, "-k", "2", "-fm", "-mdl", "norm,expon", "-pf", "fits"] + CPU)
    assert (work / "fits.pdf").stat().st_size > 0
    cli.main(["norm_vectors", bkg, "-k", "2", "-mv", "mean.npy", "-sv", "std.npy"] + CPU)
    cli.main(["kmer_leiden", bkg, "mean.npy", "std.npy", "2", "-pco", "0.3", "-sd",
              "-pn", "net"] + CPU)
    assert (work / "net.pdf").stat().st_size > 0


def test_help_prints_every_command_without_plotting_libraries(work):
    code = ("import sys\n"
            "for name in ('matplotlib', 'seaborn', 'networkx', 'pandas', 'jax'):\n"
            "    sys.modules[name] = None  # any import of them raises\n"
            "from seekr_tpu_torch import cli\n"
            "cli.main(['help'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=work, capture_output=True,
                          text=True, timeout=120, env={"PYTHONPATH": str(ROOT),
                                                       "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    sections = [lines[i + 1] for i in range(len(lines) - 2)
                if lines[i] == lines[i + 2] == "=" * 25]
    assert sections == [c for c in cli.COMMANDS if c != "help"]
    assert "flag table unavailable" not in proc.stdout and "--device" in proc.stdout
    assert cli.main(["help", "-v"]) == 0
