"""Batch all-pairs: a closed loop of ``SeekrPipeline.forward`` on the corpus.

Set-up makes the corpus on the card and warms the forward.  The window runs
forwards back to back, each ended by a synchronize, and keeps one of their
outputs, drawn from the seed (a reservoir of one), for the check: the whole
``[m, m]`` matrix against the float64 reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kbench import arith, corpus
from kbench.registry import reference


def setup(ctx):
    with ctx.span("setup.import"):
        from seekr_tpu_torch import SeekrPipeline

    cfg = ctx.config
    with ctx.span("setup.corpus"):
        bases, lengths = corpus.make_corpus(cfg["transcripts"], cfg,
                                            corpus.generator(ctx.device, ctx.seed, 0))
        _sync(ctx.device)
    with ctx.span("setup.warm"):
        pipe = SeekrPipeline(k=cfg["k"], log2=cfg["log2"], device=ctx.device)
        for _ in range(int(ctx.traffic["warm_forwards"])):
            pipe.forward(bases, lengths)
        _sync(ctx.device)
    ctx.inputs = {"m": int(bases.shape[0]), "lpad": int(bases.shape[1]), "k": cfg["k"],
                  "lengths": lengths.cpu().numpy()}
    return {"pipe": pipe, "bases": bases, "lengths": lengths, "kept": None}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(ctx, state):
    pipe, bases, lengths = state["pipe"], state["bases"], state["lengths"]
    pick = np.random.default_rng(corpus.seed_of(ctx.seed, 1))
    t_start = ctx.open_window()
    trace_on, trace_len = ctx.trace_bounds() if ctx.trace else (None, None)
    end = t_start + ctx.seconds
    forwards = 0
    now = t_start
    while now < end:
        if ctx.slice is not None and not ctx.slice.active and ctx.slice.t0 is None \
                and now >= trace_on:
            ctx.slice.start()
        with ctx.span("forward"):
            out = pipe.forward(bases, lengths)
            _sync(ctx.device)
        forwards += 1
        if ctx.slice is not None and ctx.slice.active:
            ctx.units_traced += 1
        if pick.random() * forwards < 1.0:  # reservoir of one: each forward kept with 1/n
            state["kept"] = out
        del out
        now = time.perf_counter()
        if ctx.slice is not None and ctx.slice.active and now >= ctx.slice.t0 + trace_len:
            ctx.slice.stop()
    window_s = now - t_start
    if ctx.slice is not None and ctx.slice.active:
        ctx.slice.stop()
    m = int(bases.shape[0])
    ctx.attempted = forwards
    ctx.e2e["pearson_cells_per_s"] = arith.window_rate(forwards * m * m, window_s)
    ctx.counters["forwards"] = forwards


def check(ctx, state):
    """Largest |r - r_ref| over the kept forward's whole matrix."""
    ref = reference(ctx.config)
    r_prog = state.pop("kept")
    pipe = state.pop("pipe")
    del pipe
    bases, lengths = state.pop("bases"), state.pop("lengths")
    cfg = ctx.config
    c = ref.counts_per_kb(bases, lengths, cfg["k"])
    del bases
    mean, std = ref.column_stats(c)
    z = ref.standardize_rows(ref.log2_post(c, mean, std))
    del c
    worst = 0.0
    block = 2048
    for r0 in range(0, z.shape[0], block):
        want = ref.pearson(z[r0:r0 + block], z)
        worst = max(worst, arith.max_abs_err(r_prog[r0:r0 + block], want))
    return {"r_max_abs_err": worst}
