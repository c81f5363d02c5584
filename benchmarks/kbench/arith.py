"""The metric arithmetic: window rates, device intervals, and the gaps the
checks compare."""

from __future__ import annotations

import math


def window_rate(units: float, window_s: float) -> float:
    """Work per second over the whole window (never a median of chunks)."""
    if window_s <= 0:
        raise ValueError("empty window")
    return units / window_s


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals; overlaps count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float):
    """The ``(start, end)`` gaps inside ``[start, end]`` that no interval covers."""
    gaps, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        gaps.append((cursor, end))
    return [(s, e) for s, e in gaps if e > s]


def max_abs_err(got, want) -> float:
    """Largest ``|got - want|`` of two tensors, in float64: NaN where both are
    NaN agrees, NaN on one side only, or a shape that differs, is ``inf``."""
    import torch

    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    got, want = got.to(torch.float64), want.to(torch.float64)
    g_nan, w_nan = torch.isnan(got), torch.isnan(want)
    if bool((g_nan != w_nan).any()):
        return math.inf
    if got.numel() == 0:
        return 0.0
    return float((got - want).abs().masked_fill(g_nan, 0.0).max().item())


def rank_scaled_err(got, want, p_ref) -> float:
    """Largest ``|got - want| * rank / n`` of adjusted p-values, ``rank`` the
    1-based place of each cell's ``p_ref`` in ascending order.

    Benjamini-Hochberg multiplies a p-value by ``n / rank``, so a p-value's gap
    of ``e`` can move an adjusted one by up to ``e * n / rank``; scaled back by
    ``rank / n`` it is of the order of ``e`` at every rank.  A shape that
    differs, or NaN on one side only, is ``inf``."""
    import torch

    if not tuple(got.shape) == tuple(want.shape) == tuple(p_ref.shape):
        return math.inf
    got, want = got.reshape(-1).to(torch.float64), want.reshape(-1).to(torch.float64)
    g_nan, w_nan = torch.isnan(got), torch.isnan(want)
    if bool((g_nan != w_nan).any()):
        return math.inf
    n = got.numel()
    if n == 0:
        return 0.0
    order = torch.argsort(p_ref.reshape(-1).to(torch.float64), stable=True)
    rank = torch.empty(n, dtype=torch.float64, device=got.device)
    rank[order] = torch.arange(1, n + 1, dtype=torch.float64, device=got.device)
    gap = (got - want).abs().masked_fill(g_nan, 0.0) * rank / n
    return float(gap.max().item())
