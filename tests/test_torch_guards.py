"""Guards of the port: what it imports, where it runs, and that a CUDA tensor
always goes through a CUDA kernel.

Tests marked ``gpu`` need a CUDA card and skip without one; they decide so in
the test body, so every pytest worker collects the same tests.  On the card:
``python -m pytest -m gpu tests/``.
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seekr_tpu_torch.ops import count as count_mod
from seekr_tpu_torch.ops import count_cuda
from seekr_tpu_torch.utils import build
from seekr_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
PORT_FILES = sorted((ROOT / "seekr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_seekr_tpu(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "seekr_tpu"), f"{path} imports {name}"


def test_the_process_layer_and_its_workers_import_no_jax():
    # the module of the mesh across processes is held by the test above, and the
    # worker processes of tests/test_torch_multiprocess.py (that file run as a
    # script) import neither jax nor seekr_tpu: only its tests do, inside them
    assert ROOT / "seekr_tpu_torch" / "parallel" / "comm.py" in PORT_FILES
    tree = ast.parse((ROOT / "tests" / "test_torch_multiprocess.py").read_text())
    top = [alias.name for node in tree.body if isinstance(node, ast.Import)
           for alias in node.names]
    top += [node.module for node in tree.body if isinstance(node, ast.ImportFrom)]
    assert "torch" in top
    assert not [name for name in top if name.split(".")[0] in ("jax", "jaxlib", "seekr_tpu")]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_needs_neither_pandas_nor_tqdm(path):
    # pandas nowhere; tqdm only inside a function, behind a progress flag (torch
    # itself imports tqdm where it is installed, so a fresh process cannot tell)
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in imported_modules(path):
        assert name.split(".")[0] != "pandas", f"{path} imports {name}"
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                else [node.module or ""]
            assert not any(n.split(".")[0] == "tqdm" for n in names), \
                f"{path} imports tqdm at module level"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_plotting_library_at_module_level(path):
    # the card's machine has none of them: the plots import them inside a function
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in ("networkx", "matplotlib", "seaborn")
                       for n in names), \
            f"{path} imports {names} at module level"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_needs_no_requests(path):
    # the card's machine has no requests: the downloader reads with urllib
    for name in imported_modules(path):
        assert name.split(".")[0] != "requests", f"{path} imports {name}"


ALIASES = ("fasta", "fasta_reader", "kmer_counts", "pearson", "find_dist", "find_pval",
           "adj_pval", "filter_gencode", "kmer_heatmap", "kmer_dendrogram",
           "kmer_count_barplot", "kmer_msd_barplot", "kmer_comp_textplot",
           "kmer_indi_textplot", "kmer_leiden", "my_tqdm")


def test_port_imports_without_jax_in_a_fresh_process():
    import subprocess

    code = ("import sys, seekr_tpu_torch.models.counter, seekr_tpu_torch.models.pearson, "
            "seekr_tpu_torch.models.pipeline, seekr_tpu_torch.utils.state, "
            "seekr_tpu_torch.stats, seekr_tpu_torch.cli, seekr_tpu_torch.io.stream, "
            "seekr_tpu_torch.ops.ecdf, seekr_tpu_torch.serve, seekr_tpu_torch.graph, "
            "seekr_tpu_torch.native, seekr_tpu_torch.viz.style, "
            "seekr_tpu_torch.stats.stream_adj, seekr_tpu_torch.models.workflow, "
            "seekr_tpu_torch.models.domain, seekr_tpu_torch.models.pwm, "
            "seekr_tpu_torch.data, seekr_tpu_torch.utils.doctor, "
            "seekr_tpu_torch.utils.logging, seekr_tpu_torch.utils.profiler, "
            "seekr_tpu_torch.viz, seekr_tpu_torch.ops.dist, seekr_tpu_torch.graph.maker, "
            "seekr_tpu_torch.viz.long_form, seekr_tpu_torch.utils.progress, "
            "seekr_tpu_torch.parallel, seekr_tpu_torch.parallel.mesh, "
            "seekr_tpu_torch.parallel.dist, seekr_tpu_torch.io.checkpoint, "
            + ", ".join(f"seekr_tpu_torch.{name}" for name in ALIASES) + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'seekr_tpu', 'pandas', 'networkx', 'matplotlib', 'seaborn', "
            "'requests')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch, tmp_path):
    from seekr_tpu_torch import KmerCounter, SeekrPipeline, pearson

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SeekrPipeline(k=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KmerCounter(k=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pearson(np.ones((3, 4), np.float32), np.ones((2, 4), np.float32))

    from seekr_tpu_torch import cli
    from seekr_tpu_torch.serve import SeekrService

    np.save(tmp_path / "mean.npy", np.ones(64))
    np.save(tmp_path / "std.npy", np.ones(64))
    vectors = [str(tmp_path / "mean.npy"), str(tmp_path / "std.npy")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SeekrService(*vectors, k=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", *vectors, "-k", "3", "--socket", str(tmp_path / "s.sock")])
    # the client resolves no device: without a server it fails to connect
    (tmp_path / "q.fa").write_text(">q\nACGT\n")
    with pytest.raises(OSError):
        cli.main(["query", str(tmp_path / "q.fa"), "--socket", str(tmp_path / "none.sock"),
                  "--timeout", "5"])


def test_slice_six_entry_points_do_not_fall_back_to_cpu(monkeypatch, tmp_path):
    from seekr_tpu_torch import cli
    from seekr_tpu_torch.models.domain import DomainPearson
    from seekr_tpu_torch.models.workflow import run_workflow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "a.fa").write_text(">a\nACGTACGT\n>b\nGGGTTTAA\n")
    fa = str(tmp_path / "a.fa")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_workflow(fa, background=fa, k=2, outdir=str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DomainPearson(fa, fa, k=2)
    for argv in (["pipeline", fa, "-b", fa, "-k", "2", "-o", str(tmp_path / "o")],
                 ["domain_pearson", fa, fa, "-k", "2"],
                 ["pwms", str(tmp_path), "c.npy"],
                 ["canonical_gencode", fa, str(tmp_path / "c.fa")],
                 ["filter_gencode", fa, "-rd"],
                 ["gen_rand_rnas", fa, str(tmp_path / "r.fa")],
                 ["download_gencode", "lncRNA", "-r", "40"],
                 ["adj_pval", "p.npy", "fdr_bh", "-bi"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    assert not (tmp_path / "o").exists()


def test_slice_seven_entry_points_do_not_fall_back(monkeypatch, tmp_path):
    from seekr_tpu_torch import cli
    from seekr_tpu_torch.io.fast_csv import LabeledMatrix
    from seekr_tpu_torch.ops.dist import pdist_auto, pdist_device
    from seekr_tpu_torch.viz import (kmer_count_barplot, kmer_dendrogram, kmer_heatmap,
                                     kmer_msd_barplot)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "a.fa").write_text(">a\nACGTACGT\n>b\nGGGTTTAA\n")
    fa = str(tmp_path / "a.fa")
    np.save(tmp_path / "mean.npy", np.ones(16))
    np.save(tmp_path / "std.npy", np.ones(16))
    vectors = (str(tmp_path / "mean.npy"), str(tmp_path / "std.npy"))
    x = np.random.default_rng(0).normal(size=(4, 6))
    sim = LabeledMatrix(np.corrcoef(x), list("abcd"), list("abcd"))
    for call in (lambda: kmer_count_barplot(fa, *vectors, 2),
                 lambda: kmer_msd_barplot(fa, *vectors, 2),
                 lambda: pdist_device(x),
                 lambda: pdist_auto(x),
                 lambda: kmer_heatmap(sim, -1, 1, outputname=str(tmp_path / "h")),
                 lambda: kmer_dendrogram(sim, outputname=str(tmp_path / "d"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    np.save(tmp_path / "sim.npy", sim.values)
    sim.to_csv(tmp_path / "sim.csv")
    for argv in (["kmer_heatmap", str(tmp_path / "sim.csv"), "-1", "1"],
                 ["kmer_dendrogram", str(tmp_path / "sim.csv")],
                 ["kmer_count_barplot", fa, *vectors, "2"],
                 ["kmer_msd_barplot", fa, *vectors, "2"],
                 ["kmer_comp_textplot", fa, fa, "AC"],
                 ["kmer_indi_textplot", fa, "AC"],
                 ["graph", str(tmp_path / "sim.npy")],
                 ["visualize_distro", str(tmp_path / "sim.npy")]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "a.fa", "mean.npy", "sim.csv", "sim.npy", "std.npy"]


def test_mesh_modules_are_guarded():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"seekr_tpu_torch/parallel/__init__.py", "seekr_tpu_torch/parallel/mesh.py",
            "seekr_tpu_torch/parallel/dist.py", "seekr_tpu_torch/io/checkpoint.py"} <= names
    for name in ("parallel/mesh.py", "parallel/dist.py", "io/checkpoint.py"):
        assert "orbax" not in {m.split(".")[0] for m in
                               imported_modules(ROOT / "seekr_tpu_torch" / name)}


def test_slice_eight_entry_points_do_not_fall_back(monkeypatch, tmp_path):
    from seekr_tpu_torch import cli
    from seekr_tpu_torch.graph.kmer_leiden import kmer_leiden
    from seekr_tpu_torch.parallel.mesh import build_mesh_from_flags, make_mesh
    from seekr_tpu_torch.stats import find_dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()  # never the CPU on its own
    with pytest.raises(ValueError, match="have 0"):
        build_mesh_from_flags(4)
    (tmp_path / "a.fa").write_text(">a\nACGTACGT\n>b\nGGGTTTAA\n")
    fa = str(tmp_path / "a.fa")
    np.save(tmp_path / "mean.npy", np.ones(16))
    np.save(tmp_path / "std.npy", np.ones(16))
    vectors = (str(tmp_path / "mean.npy"), str(tmp_path / "std.npy"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        find_dist(fa, k_mer=2, data_parallel=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kmer_leiden(fa, *vectors, 2, data_parallel=4)
    monkeypatch.chdir(tmp_path)
    for argv in (["find_dist", fa, "-k", "2", "-dp", "4"],
                 ["find_pval", fa, fa, *vectors, "2", "f.csv", "-dp", "4"],
                 ["kmer_leiden", fa, *vectors, "2", "-dp", "4"],
                 ["pipeline", fa, "-b", fa, "-k", "2", "-dp", "4"],
                 ["serve", *vectors, "-k", "2", "-t", fa, "-dp", "4"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.fa", "mean.npy", "std.npy"]


def test_kernel_wrapper_refuses_cpu_tensors():
    b = torch.zeros((2, 8), dtype=torch.int8)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        count_cuda.count_kmers_cuda(b, n, 3)


def test_kernel_routing():
    assert [count_cuda.kernel_for(k) for k in (1, 6, 7, 8, 10)] == [
        "count_kmers_smem", "count_kmers_smem", "count_kmers_smem",
        "count_kmers_hiblocked", "count_kmers_hiblocked"]
    assert count_cuda.split_hi_lo(6) == (32, 128)
    assert count_cuda.split_hi_lo(2) == (1, 16)


@pytest.mark.parametrize("k", range(8, 16))
def test_hiblock_plan_covers_every_bin_once(k):
    n_bins = 4 ** k
    slice_bins, n_slices = count_cuda.hiblock_plan(k)
    # the kernel's slice of code c is c >> log2(S), its bin c & (S - 1); the C
    # function takes 8 <= S <= 2^14 (64 KB of int32 bins)
    assert slice_bins & (slice_bins - 1) == 0 and 8 <= slice_bins <= 1 << 14
    assert slice_bins * n_slices == n_bins
    if k <= 11:
        codes = np.arange(n_bins)
        shift = slice_bins.bit_length() - 1
        owners = (codes >> shift) * slice_bins + (codes & (slice_bins - 1))
        np.testing.assert_array_equal(np.bincount(owners, minlength=n_bins), 1)
        np.testing.assert_array_equal(np.bincount(codes >> shift), slice_bins)


def test_hiblock_plan_refuses_small_k():
    with pytest.raises(ValueError):
        count_cuda.hiblock_plan(count_cuda.SMEM_MAX_K)
    with pytest.raises(ValueError):
        count_cuda.hiblock_plan(count_cuda.MAX_K + 1)


@pytest.mark.parametrize("lpad", [300, 1100])
@pytest.mark.parametrize("k", [8, 9, 10])
def test_count_slice_by_slice_equals_whole(k, lpad):
    # the decomposition count_kmers_hiblocked relies on: each slice's histogram
    # from the codes masked to that slice, concatenated, is the whole histogram
    rng = np.random.default_rng(k)
    b, n = (torch.from_numpy(a) for a in chip_smoke.kernel_case(rng, 5, lpad, k))
    slice_bins, n_slices = count_cuda.hiblock_plan(k)
    code, valid = count_mod.window_codes(b, n, k)
    row = torch.arange(5)[:, None] * slice_bins
    parts = []
    for s in range(n_slices):
        sel = valid & (code // slice_bins == s)
        hist = torch.bincount((code % slice_bins + row)[sel], minlength=5 * slice_bins)
        parts.append(hist.view(5, slice_bins))
    raw = torch.cat(parts, dim=1).to(torch.float32)
    assert torch.equal(raw, count_mod.count_torch(b, n, k, scaled=False))
    assert torch.equal(count_mod._scale(raw, n, k), count_mod.count_torch(b, n, k))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(build.os, "access", lambda *a: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.find_nvcc()


def test_failed_compile_raises_with_output(tmp_path):
    with pytest.raises(build.KernelBuildError, match="boom"):
        build._run_all([[sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"]])


def test_source_hash_follows_sources(monkeypatch, tmp_path):
    (tmp_path / "a.cu").write_text("int x;")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build._source_hash("nvcc")
    (tmp_path / "a.cu").write_text("int y;")
    assert build._source_hash("nvcc") != before


def test_native_library_is_the_ports_own():
    from seekr_tpu_torch import native
    from seekr_tpu_torch.native import build as native_build

    path = Path(native.library_path()).resolve()
    assert path.parent == ROOT / "seekr_tpu_torch" / "_build"
    assert path.name.startswith("libseekr_tpu_torch_native.")
    assert native.native_available() and native.load_error() is None
    # the process never loaded seekr_tpu's copy through the port
    assert native_build.SRC_DIR == ROOT / "seekr_tpu_torch" / "native" / "src"
    assert sorted(p.name for p in native_build.SRC_DIR.iterdir()) == sorted(
        native_build.SOURCES + native_build.HEADERS)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_native_build_raises_without_a_working_gxx(monkeypatch, tmp_path, compiler):
    from seekr_tpu_torch.native import build as native_build

    if compiler == "missing":
        cxx = str(tmp_path / "no-such-g++")
    else:
        cxx = str(tmp_path / "g++")
        Path(cxx).write_text("#!/bin/sh\necho 'error: boom' >&2\nexit 1\n")
        Path(cxx).chmod(0o755)
    monkeypatch.setattr(native_build, "CXX", cxx)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    match = "failed to run" if compiler == "missing" else "boom"
    with pytest.raises(native_build.NativeBuildError, match=match):
        native_build.build_native_lib()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_native_loader_raises_instead_of_falling_back(monkeypatch):
    from seekr_tpu_torch import native

    def fail():
        raise native.NativeBuildError("g++ failed: boom")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "build_native_lib", fail)
    with pytest.raises(native.NativeBuildError, match="boom"):
        native.argsort_f64(np.arange(3.0))
    monkeypatch.setenv("SEEKR_TPU_HOST_SORT", "native")
    from seekr_tpu_torch.stats.multitest import multipletests

    with pytest.raises(native.NativeBuildError):
        multipletests(np.array([0.1, 0.2, 0.3]))
    assert not native.native_available() and "boom" in native.load_error()


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def random_case(rng, m, L, k, device):
    bases = rng.integers(0, 5, size=(m, L), dtype=np.int8)
    lengths = rng.integers(0, L + 1, size=m).astype(np.int32)
    lengths[0] = k - 1
    for r in range(m):
        bases[r, lengths[r]:] = 4
    if k > count_cuda.SMEM_MAX_K:
        bases[-1] = chip_smoke.slice_edge_row(rng, k, L)
        lengths[-1] = L
    return torch.as_tensor(bases, device=device), torch.as_tensor(lengths, device=device)


@pytest.mark.gpu
def test_gpu_count_graph_never_calls_the_plain_version(monkeypatch):
    device = need_cuda()

    def refuse(*args, **kwargs):
        raise AssertionError("count_torch was called for a CUDA tensor")

    monkeypatch.setattr(count_mod, "count_torch", refuse)
    rng = np.random.default_rng(0)
    for k in (3, 6, 8, 10):
        b, n = random_case(rng, 16, 300, k, device)
        name = count_cuda.kernel_for(k)
        before = count_cuda.launches[name]
        out = count_mod.count_graph(b, n, k)
        torch.cuda.synchronize()
        assert out.is_cuda and out.shape == (16, 4 ** k)
        assert count_cuda.launches[name] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("k", range(1, 13))
def test_gpu_kernels_bitwise_equal_plain_version(k):
    # at k >= 8 the last row hits both edges of the slices
    device = need_cuda()
    rng = np.random.default_rng(k)
    b, n = random_case(rng, 64 if k <= 8 else 8, 2100, k, device)
    for scaled in (True, False):
        for flat in (True, False):
            got = count_cuda.count_kmers_cuda(b, n, k, scaled=scaled, flat=flat)
            want = count_mod.count_torch(b, n, k, scaled=scaled, flat=flat)
            torch.cuda.synchronize()
            assert got.shape == want.shape and torch.equal(got, want)


def test_one_code_rows_fill_one_bin_each():
    b, n = (torch.from_numpy(a) for a in chip_smoke.one_code_case(9))
    raw = count_mod.count_torch(b, n, 9, scaled=False)
    assert raw[0, 0].item() == 65_536 and raw[1, -1].item() == 65_535
    assert raw.sum().item() == 65_536 + 65_535


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 9])
def test_gpu_hiblocked_bins_count_past_16_bits(k):
    # one bin of each row counts every window: 65,536 and 65,535 of them
    device = need_cuda()
    b, n = (torch.as_tensor(a, device=device) for a in chip_smoke.one_code_case(k))
    for scaled in (True, False):
        got = count_cuda.count_kmers_cuda(b, n, k, scaled=scaled)
        want = count_mod.count_torch(b, n, k, scaled=scaled)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_gpu_wrapper_checks_its_inputs():
    device = need_cuda()
    b = torch.zeros((4, 16), dtype=torch.int8, device=device)
    n = torch.zeros(4, dtype=torch.int32, device=device)
    with pytest.raises(TypeError):
        count_cuda.count_kmers_cuda(b.to(torch.int32), n, 3)
    with pytest.raises(TypeError):
        count_cuda.count_kmers_cuda(b, n.to(torch.int64), 3)
    with pytest.raises(ValueError, match="contiguous"):
        count_cuda.count_kmers_cuda(b.t().contiguous().t(), n, 3)
    with pytest.raises(ValueError):
        count_cuda.count_kmers_cuda(b, n[:3], 3)
    with pytest.raises(ValueError):
        count_cuda.count_kmers_cuda(b, n, 16)
    with pytest.raises(ValueError):
        count_cuda.count_kmers_cuda(b[:, :2].contiguous(), n, 3)
    assert count_cuda.count_kmers_cuda(b[:0], n[:0], 3).shape == (0, 64)


@pytest.mark.gpu
def test_gpu_pipeline_matches_cpu_run():
    device = need_cuda()
    from seekr_tpu_torch import SeekrPipeline

    rng = np.random.default_rng(1)
    bases = rng.integers(0, 4, size=(64, 700), dtype=np.int8)
    lengths = rng.integers(400, 701, size=64).astype(np.int32)
    for r in range(64):
        bases[r, lengths[r]:] = 4
    gpu = SeekrPipeline(k=4, device=device).forward(bases, lengths).cpu().numpy()
    cpu = SeekrPipeline(k=4, device="cpu").forward(bases, lengths).numpy()
    np.testing.assert_allclose(gpu, cpu, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_gpu_stats_chain_matches_cpu_run(tmp_path, monkeypatch):
    device = need_cuda()
    from seekr_tpu_torch.io.fasta import write_fasta
    from seekr_tpu_torch.ops.ecdf import ecdf_sf
    from seekr_tpu_torch.ops.pearson import pearson_pairs
    from seekr_tpu_torch.stats import find_dist, find_pval
    from seekr_tpu_torch.stats.find_dist import fit_distributions

    monkeypatch.chdir(tmp_path)  # find_dist writes its vectors here
    rng = np.random.default_rng(5)
    for name, m in (("bkg", 60), ("q", 12)):
        seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(150, 900))))
                for _ in range(m)]
        write_fasta(f"{name}.fa", [f"{name}{i}" for i in range(m)], seqs)
    runs = {}
    for dev in (device, "cpu"):
        np.random.seed(6)
        runs[str(dev)] = find_dist("bkg.fa", k_mer=3, subset_size=500, fit_model=False,
                                   device=dev)
    np.testing.assert_allclose(runs[str(device)], runs["cpu"], rtol=0, atol=1e-5)
    fitres = fit_distributions(runs["cpu"], ["norm", "expon"])
    vectors = ("bkg_mean_3mers.npy", "bkg_std_3mers.npy")
    gpu = find_pval("q.fa", "bkg.fa", *vectors, 3, fitres, device=device)
    cpu = find_pval("q.fa", "bkg.fa", *vectors, 3, fitres, device="cpu")
    np.testing.assert_allclose(gpu.values, cpu.values, rtol=0, atol=1e-5)
    counts = rng.random((50, 64)).astype(np.float32)
    ii, jj = rng.integers(0, 50, size=(2, 300))
    np.testing.assert_allclose(pearson_pairs(counts, ii, jj, device=device),
                               pearson_pairs(counts, ii, jj, device="cpu"), rtol=0, atol=1e-6)
    finite = torch.sort(torch.as_tensor(runs["cpu"])).values
    r = torch.as_tensor(cpu.values)
    assert torch.equal(ecdf_sf(finite.to(device), r.to(device)).cpu(), ecdf_sf(finite, r))


def null_away_from(r, n, dtype, rng, margin=1e-4):
    """About ``n`` null values in [-1, 1], none within ``margin`` of any r,
    with a run of exact repeats and every 97th NaN.  The card's r lie within
    1e-5 of the CPU's, so each counts the same null values greater."""
    r = np.sort(r[np.isfinite(r)].astype(np.float64).ravel())
    vals = rng.uniform(-1, 1, n)
    i = np.clip(np.searchsorted(r, vals), 1, len(r) - 1)
    null = vals[np.minimum(np.abs(vals - r[i - 1]), np.abs(vals - r[i])) >= margin]
    null = null.astype(dtype)
    null[1:200:2] = null[0]
    null[::97] = np.nan
    return null


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["queries", "self", "streamed"])
def test_gpu_empirical_find_pval_is_the_cpu_runs_bits(case, tmp_path, monkeypatch):
    device = need_cuda()
    from seekr_tpu_torch.io.fasta import write_fasta
    from seekr_tpu_torch.models.counter import KmerCounter
    from seekr_tpu_torch.models.pearson import pearson
    from seekr_tpu_torch.ops import ecdf
    from seekr_tpu_torch.stats import find_pval

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(11)
    for name, m in (("bkg", 60), ("q", 12)):
        seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(150, 900))))
                for _ in range(m)]
        write_fasta(f"{name}.fa", [f"{name}{i}" for i in range(m)], seqs)
    counter = KmerCounter("bkg.fa", k=3, silent=True, device="cpu")
    counter.get_counts()
    vectors = ("mean.npy", "std.npy")
    np.save(vectors[0], counter.mean)
    np.save(vectors[1], counter.std)
    query = "bkg.fa" if case == "self" else "q.fa"
    counts = KmerCounter(query, mean=vectors[0], std=vectors[1], k=3, silent=True,
                         device="cpu").get_counts()
    r = pearson(counts, counts if case == "self" else KmerCounter(
        "bkg.fa", mean=vectors[0], std=vectors[1], k=3, silent=True, device="cpu").get_counts(),
        device="cpu")
    # past 2^24 values the denominator needs float64; the CLI's loadtxt gives float64
    size, dtype = {"queries": (2 ** 24 + 2 ** 22, np.float32), "self": (200_000, np.float64),
                   "streamed": (200_000, np.float32)}[case]
    null = null_away_from(r, size, dtype, rng)
    if case == "queries":
        assert len(null) > 2 ** 24
    p, used = {}, {}
    for dev in (device, torch.device("cpu")):
        before = dict(ecdf.evaluations)
        kw = {"stream": True, "npy_out": f"{dev.type}.npy",
              "stream_block_rows": 5} if case == "streamed" else {}
        out = find_pval(query, "bkg.fa", *vectors, 3, null, progress_bar=False, device=dev,
                        **kw)
        p[dev.type] = np.load(f"{dev.type}.npy") if case == "streamed" else out.values
        used[dev.type] = {key: ecdf.evaluations[key] - before[key] for key in before}
    assert p["cuda"].dtype == np.float32 and p["cuda"].tobytes() == p["cpu"].tobytes()
    calls = 3 if case == "streamed" else 1  # 12 rows in blocks of 5
    assert used == {"cuda": {"device": calls, "host": 0}, "cpu": {"device": 0, "host": calls}}
    if case == "self":
        assert np.array_equal(p["cuda"], p["cuda"].T)


def serve_case(tmp_path, rng, n_targets=6):
    letters = np.array(list("AGTC"))
    seqs = ["".join(letters[rng.integers(0, 4, size=int(rng.integers(60, 200)))])
            for _ in range(n_targets + 5)]
    np.save(tmp_path / "mean.npy", rng.uniform(0.5, 2.0, 64))
    np.save(tmp_path / "std.npy", rng.uniform(0.5, 2.0, 64))
    (tmp_path / "t.fa").write_text("".join(f">t{i}\n{s}\n" for i, s in
                                           enumerate(seqs[:n_targets])))
    return [str(tmp_path / "mean.npy"), str(tmp_path / "std.npy")], seqs[n_targets:]


@pytest.mark.gpu
def test_gpu_service_matches_cpu_run(tmp_path):
    device = need_cuda()
    from seekr_tpu_torch.serve import SeekrService

    rng = np.random.default_rng(7)
    vectors, queries = serve_case(tmp_path, rng)
    bkg = np.sort(rng.normal(0, 0.3, 5000))
    outs = {}
    for dev in (device, "cpu"):
        svc = SeekrService(*vectors, k=3, targets=str(tmp_path / "t.fa"), fitres=bkg,
                           device=dev)
        before = count_cuda.launches["count_kmers_smem"]
        outs[str(dev)] = svc.query(queries, want=("sim", "pvals", "topk"), topk=4)
        if dev == device:
            assert count_cuda.launches["count_kmers_smem"] > before
    got, want = outs[str(device)], outs["cpu"]
    np.testing.assert_allclose(got["sim"], want["sim"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["topk_sim"], want["topk_sim"], rtol=0, atol=1e-5)
    assert got["topk_idx"].dtype == np.int32 and got["topk_idx"].shape == (5, 4)


@pytest.mark.gpu
def test_gpu_topk_ties_go_to_the_lower_index():
    device = need_cuda()
    from seekr_tpu_torch.serve import _topk

    rng = np.random.default_rng(8)
    # few distinct values over wide rows: every row is full of exact ties
    sim = torch.as_tensor(rng.integers(-2, 3, size=(64, 13_056)).astype(np.float32) / 4,
                          device=device)
    vals, idx = _topk(sim, 13_000, 16, True)
    want = np.argsort(-sim.cpu().numpy()[:, :13_000], axis=1, kind="stable")[:, :16]
    np.testing.assert_array_equal(idx.cpu().numpy(), want)
    np.testing.assert_array_equal(vals.cpu().numpy(),
                                  np.take_along_axis(sim.cpu().numpy(), want, 1))


@pytest.mark.gpu
def test_gpu_request_alone_does_not_initialise_cuda(tmp_path):
    need_cuda()
    code = f"""
import sys, threading
sys.path.insert(0, {str(ROOT)!r})
import numpy as np
import torch
from seekr_tpu_torch import cli
from seekr_tpu_torch.serve import SeekrService, request, serve_forever

svc = SeekrService({str(tmp_path / 'mean.npy')!r}, {str(tmp_path / 'std.npy')!r}, k=3,
                   targets={str(tmp_path / 't.fa')!r}, device="cpu")
ready = threading.Event()
t = threading.Thread(target=serve_forever, args=(svc, "s.sock", ready), daemon=True)
t.start()
assert ready.wait(30)
assert request("s.sock", {{"op": "ping"}}, timeout=30)["ok"]
cli.main(["query", {str(tmp_path / 'q.fa')!r}, "--socket", "s.sock", "--timeout", "30",
          "-o", "out.csv"])
assert request("s.sock", {{"op": "shutdown"}}, timeout=30)["ok"]
t.join(30)
assert not t.is_alive()
assert not torch.cuda.is_initialized()
"""
    _, queries = serve_case(tmp_path, np.random.default_rng(9))
    (tmp_path / "q.fa").write_text("".join(f">q{i}\n{s}\n" for i, s in enumerate(queries)))
    import subprocess

    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.gpu
def test_gpu_kmer_leiden_matches_cpu_run(tmp_path):
    device = need_cuda()
    import importlib

    from seekr_tpu_torch.io.fasta import write_fasta

    leiden = importlib.import_module("seekr_tpu_torch.graph.kmer_leiden")
    rng = np.random.default_rng(12)
    letters = np.array(list("AGTC"))
    names, seqs = [], []
    for f in range(6):
        founder = rng.integers(0, 4, size=int(rng.integers(400, 900)))
        for j in range(10):
            s = founder.copy()
            hit = rng.random(s.size) < 0.1
            s[hit] = rng.integers(0, 4, size=int(hit.sum()))
            names.append(f"f{f}_{j}")
            seqs.append("".join(letters[s]))
    write_fasta(str(tmp_path / "c.fa"), names, seqs)
    np.save(tmp_path / "mean.npy", rng.uniform(5, 15, 256))
    np.save(tmp_path / "std.npy", rng.uniform(2, 6, 256))
    args = (str(tmp_path / "c.fa"), str(tmp_path / "mean.npy"), str(tmp_path / "std.npy"), 4)
    for stream in (False, True):
        before = count_cuda.launches["count_kmers_smem"]
        got = leiden.kmer_leiden(*args, pearsoncutoff=0.2, setseed=True, stream=stream,
                                 device=device)
        assert count_cuda.launches["count_kmers_smem"] > before
        want = leiden.kmer_leiden(*args, pearsoncutoff=0.2, setseed=True, stream=stream,
                                  device="cpu")
        pairs = set(zip(got.tolist(), want.tolist()))  # one partition, relabeled
        assert len(pairs) == len(set(got.tolist())) == len(set(want.tolist()))
    gpu = leiden.similarity_graph(*args, 0.2, device=device).values
    cpu = leiden.similarity_graph(*args, 0.2, device="cpu").values
    np.testing.assert_allclose(gpu, cpu, rtol=0, atol=1e-5)
    clear = np.abs(cpu - 0.2) > 1e-5
    assert np.array_equal((gpu > 0) & clear, (cpu > 0) & clear)


@pytest.mark.gpu
def test_gpu_workflow_matches_cpu_run(tmp_path):
    device = need_cuda()
    from seekr_tpu_torch.models.domain import DomainPearson
    from seekr_tpu_torch.models.workflow import run_workflow

    fixtures = ROOT / "tests" / "fixtures"
    queries, background = str(fixtures / "ldseq.fa"), str(fixtures / "seqs1.fa")
    runs = {}
    for dev in (device, "cpu"):
        before = count_cuda.launches["count_kmers_smem"]
        runs[str(dev)] = run_workflow(queries, background=background, k=3,
                                      outdir=str(tmp_path / str(dev).replace(":", "_")),
                                      subset_size=500, seed=2, leiden=True, leiden_cutoff=0.1,
                                      device=dev)
        if dev == device:
            assert count_cuda.launches["count_kmers_smem"] > before
    gpu, cpu = runs[str(device)], runs["cpu"]
    np.testing.assert_allclose(gpu["mean"], cpu["mean"], rtol=1e-6)
    np.testing.assert_allclose(gpu["counts1"], cpu["counts1"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(gpu["pearson"], cpu["pearson"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(gpu["null_sample"], cpu["null_sample"], rtol=0, atol=1e-5)
    bkg = np.sort(cpu["null_sample"].astype(np.float64))
    r = cpu["pearson"].astype(np.float64)
    ties = np.searchsorted(bkg, r + 1e-5, side="right") > np.searchsorted(bkg, r - 1e-5)
    assert np.array_equal(gpu["pvals"].values[~ties], cpu["pvals"].values[~ties])
    assert len(set(zip(gpu["communities"].tolist(), cpu["communities"].tolist()))) == \
        len(set(cpu["communities"].tolist()))
    before = count_cuda.launches["count_kmers_smem"]
    dom = {dev: DomainPearson(queries, background, background, k=3, window=200, slide=50,
                              device=dev).run().values for dev in (device, "cpu")}
    assert count_cuda.launches["count_kmers_smem"] > before
    np.testing.assert_allclose(dom[device], dom["cpu"], rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_gpu_mesh_on_one_card_matches_the_cpu_mesh():
    # four shards on one card run every line of the sharded code and its kernels
    device = need_cuda()
    from seekr_tpu_torch.io.stream import ArrayCollector
    from seekr_tpu_torch.parallel import dist
    from seekr_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(2)
    bases = rng.integers(0, 4, size=(64, 700), dtype=np.int8)
    lengths = rng.integers(400, 701, size=64).astype(np.int32)
    for r in range(64):
        bases[r, lengths[r]:] = 4
    results = {}
    for dev in (device, torch.device("cpu")):
        meshes = (make_mesh([dev] * 4), make_mesh([dev] * 4, kmer_parallel=2))
        before = dict(count_cuda.launches)
        out = [np.asarray(x) for x in dist.distributed_pipeline(meshes[1], k=4)(bases, lengths)]
        out.append(np.asarray(dist.distributed_norm_stats(meshes[0], k=9)(bases, lengths)[1]))
        chunks, n_windows = dist.shard_long_sequence(bases[0, :lengths[0]], 6, 4)
        out.append(np.asarray(dist.count_long_sequence(meshes[0], 6)(chunks, n_windows).cpu()))
        w = ArrayCollector()
        dist.stream_pearson_sharded(meshes[0], out[0], w, block_rows=24)
        out.append(w.result())
        if dev == device:
            # 2 data shards of the (2, 2) pipeline, 4 chunks of the long sequence
            assert count_cuda.launches["count_kmers_smem"] >= before["count_kmers_smem"] + 6
            assert count_cuda.launches["count_kmers_hiblocked"] >= \
                before["count_kmers_hiblocked"] + 4
        results[str(dev)] = out
    gpu, cpu = results[str(device)], results["cpu"]
    assert np.array_equal(gpu[5], cpu[5])  # the long sequence's counts, bitwise
    for g, c in zip(gpu[:5] + gpu[6:], cpu[:5] + cpu[6:]):
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_gpu_k9_pearson_within_the_budget_of_float64():
    # 262,144 columns: as one cuBLAS product outside 1e-4 of float64 on the
    # H100 at this size; summed in 4,096-column pieces (ops.pearson.gram) inside
    device = need_cuda()
    from seekr_tpu_torch import SeekrPipeline

    rng = np.random.default_rng(9)
    bases = rng.integers(0, 4, size=(2048, 4096), dtype=np.int8)
    lengths = rng.integers(2048, 4097, size=2048).astype(np.int32)
    for r in range(2048):
        bases[r, lengths[r]:] = 4
    pipe = SeekrPipeline(k=9, log2="Log2.none", device=device)
    mean = torch.zeros(4 ** 9)
    std = torch.ones(4 ** 9)
    counts = pipe.counts(bases, lengths, mean, std)[0].double()
    z = counts - counts.mean(dim=1, keepdim=True)
    z = z / z.std(dim=1, keepdim=True, correction=0)
    want = (z @ z.T) / z.shape[1]
    got = pipe.forward(bases, lengths, mean, std).double()
    assert (got - want).abs().max().item() <= 1e-4
