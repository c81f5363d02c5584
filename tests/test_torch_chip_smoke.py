"""Rehearsal of chip_smoke.py on the CPU.

Every phase runs at a tiny scale with ``device="cpu"``: the port's plain
versions stand in for the kernels, and the kernel comparisons and timings are
skipped (they need the card).  ``main()`` itself must refuse to run without a
CUDA card, and the script alone, without the package beside it, must fail.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_phases_rehearse_on_cpu():
    state = chip_smoke.run(torch.device("cpu"), chip_smoke.TINY, seed=0)
    m = chip_smoke.TINY.corpus_m
    assert state["sim"].shape == (m, m)
    assert len(state["large_k_seqs"]) == chip_smoke.TINY.large_k_m
    # no kernel runs on the CPU, and no launch is counted
    assert state["launches"] == {"count_kmers_smem": 0, "count_kmers_gmem": 0}


def test_corpus_is_seeded_and_shaped():
    b1, n1 = chip_smoke.make_corpus(50, 4096, seed=3)
    b2, n2 = chip_smoke.make_corpus(50, 4096, seed=3)
    assert np.array_equal(b1, b2) and np.array_equal(n1, n2)
    assert b1.shape == (50, 4096) and b1.dtype == np.int8
    assert n1.min() >= 200 and n1.max() <= 4096
    assert (b1[np.arange(4096)[None, :] >= n1[:, None]] == 4).all()


def test_needed_bytes():
    # rows with no window move no digits; every row writes its output row
    got = chip_smoke._needed_bytes(np.array([0, 5, 100, 9000]), 4096, 6)
    assert got == (100 + 4096) + 4 * 4 + 4 * 4 * 4096


def test_main_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def test_script_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
