"""The metric arithmetic on canned records."""

from __future__ import annotations

import math

import pytest
import torch
from kbench import arith


def test_window_rate_is_all_work_over_all_time():
    assert arith.window_rate(3 * 169_000_000, 0.105) == pytest.approx(4.8285714e9)
    with pytest.raises(ValueError):
        arith.window_rate(1, 0.0)


def test_union_counts_overlaps_once_and_gaps_are_the_rest():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.2, 2.4)]
    assert arith.union_length(iv) == pytest.approx(2.5)
    assert arith.idle_gaps(iv, 0.0, 4.0) == [(1.5, 2.0), (3.0, 4.0)]
    assert arith.union_length([]) == 0.0


def test_max_abs_err_treats_nan_and_shape():
    a = torch.tensor([1.0, float("nan"), 3.0])
    assert arith.max_abs_err(a, torch.tensor([1.0, float("nan"), 3.5])) == pytest.approx(0.5)
    assert arith.max_abs_err(a, torch.tensor([1.0, 2.0, 3.0])) == math.inf
    assert arith.max_abs_err(a, torch.zeros(4)) == math.inf


def test_rank_scaled_err_undoes_the_n_over_rank_of_bh():
    p_ref = torch.tensor([0.04, 0.01, 0.03, 0.02])  # ranks 4, 1, 3, 2
    want = torch.tensor([0.04, 0.04, 0.04, 0.04])
    got = want + torch.tensor([0.0, 0.008, 0.0, 0.002])
    # 0.008 at rank 1 and 0.002 at rank 2 of n = 4: 0.002 and 0.001
    assert arith.rank_scaled_err(got, want, p_ref) == pytest.approx(0.002)
    assert arith.rank_scaled_err(got, want, p_ref[:3]) == math.inf
    assert arith.rank_scaled_err(torch.tensor([float("nan")]), torch.tensor([0.1]),
                                 torch.tensor([0.1])) == math.inf
