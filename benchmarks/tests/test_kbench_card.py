"""On the card: a tiny run of each cell is correct, and with the program's own
TF32 path switched on (``SEEKR_TPU_MATMUL_PRECISION=default``), the control,
it is not.  Skips where there is no card."""

from __future__ import annotations

import time

import pytest
from conftest import CELLS, tiny_cell


def _run(cell):
    import torch

    from kbench import runner

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return runner.run_cell(tiny_cell(cell), 2**31 + 11, 1.0, False, torch.device("cuda", 0),
                           time.perf_counter())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_sound_on_the_card(cell, monkeypatch):
    monkeypatch.delenv("SEEKR_TPU_MATMUL_PRECISION", raising=False)
    assert _run(cell)["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_fails(cell, monkeypatch):
    monkeypatch.setenv("SEEKR_TPU_MATMUL_PRECISION", "default")
    assert not _run(cell)["correct"]
