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


def test_port_imports_without_jax_in_a_fresh_process():
    import subprocess

    code = ("import sys, seekr_tpu_torch.models.counter, seekr_tpu_torch.models.pearson, "
            "seekr_tpu_torch.models.pipeline, seekr_tpu_torch.utils.state; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'seekr_tpu')]; "
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


def test_kernel_wrapper_refuses_cpu_tensors():
    b = torch.zeros((2, 8), dtype=torch.int8)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        count_cuda.count_kmers_cuda(b, n, 3)


def test_kernel_routing():
    assert [count_cuda.kernel_for(k) for k in (1, 6, 7, 8, 10)] == [
        "count_kmers_smem", "count_kmers_smem", "count_kmers_smem",
        "count_kmers_gmem", "count_kmers_gmem"]
    assert count_cuda.split_hi_lo(6) == (32, 128)
    assert count_cuda.split_hi_lo(2) == (1, 16)


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
@pytest.mark.parametrize("k", range(1, 11))
def test_gpu_kernels_bitwise_equal_plain_version(k):
    device = need_cuda()
    rng = np.random.default_rng(k)
    b, n = random_case(rng, 64 if k <= 8 else 8, 2100, k, device)
    for scaled in (True, False):
        for flat in (True, False):
            got = count_cuda.count_kmers_cuda(b, n, k, scaled=scaled, flat=flat)
            want = count_mod.count_torch(b, n, k, scaled=scaled, flat=flat)
            torch.cuda.synchronize()
            assert got.shape == want.shape and torch.equal(got, want)


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
