"""Significance: ``find_pval`` against an empirical null, then ``adj_pval``.

Set-up writes the background FASTA, its norm vectors (as ``norm_vectors``
does) and the null of every background pair (``find_dist(subsetting=False,
fit_model=False)``, saved as a ``.npy`` file) in a working directory under the
temporary directory, and warms the chain with a batch of its own.  Each call of
the window is one-shot, as one ``seekr_find_pval`` per query FASTA: it writes a
fresh FASTA of query transcripts made from the seed, loads the null from its
file, runs ``find_pval`` and ``adj_pval``, and keeps nothing of the program's
for the next call; both results end on the host.  The check recomputes every
call's p-values and adjusted p-values from the digits, null included.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from kbench import arith, corpus
from kbench.registry import reference

QUERY_STREAM = 2
WARM_STREAM = 3
WARM_NULL = 4096


def _batch(ctx, stream: int, i: int):
    cfg = ctx.config
    return corpus.make_corpus(int(ctx.traffic["queries_per_call"]), cfg,
                              corpus.generator(ctx.device, ctx.seed, stream, i))


def setup(ctx):
    with ctx.span("setup.import"):
        from seekr_tpu_torch.models.counter import KmerCounter
        from seekr_tpu_torch.stats import adj_pval, find_dist, find_pval  # noqa: F401

    cfg = ctx.config
    work = tempfile.mkdtemp(prefix="kbench_pval_")
    home = os.getcwd()
    ctx.at_exit(lambda: (os.chdir(home), shutil.rmtree(work, ignore_errors=True)))
    os.chdir(work)  # find_dist writes bkg_{mean,std}_{k}mers.npy here
    with ctx.span("setup.corpus"):
        bases, lengths = corpus.make_corpus(cfg["transcripts"], cfg,
                                            corpus.generator(ctx.device, ctx.seed, 0))
        bg = os.path.join(work, "background.fa")
        corpus.write_fasta(bg, corpus.to_strings(bases, lengths))
    with ctx.span("setup.norm_vectors"):
        counter = KmerCounter(bg, k=cfg["k"], log2=cfg["log2"], silent=True,
                              device=ctx.device)
        counter.get_counts_device()
        mean, std = os.path.join(work, "mean.npy"), os.path.join(work, "std.npy")
        np.save(mean, counter.mean)
        np.save(std, counter.std)
        del counter
    with ctx.span("setup.find_dist"):
        null = find_dist(bg, k_mer=cfg["k"], log2=cfg["log2"], subsetting=False,
                         fit_model=False, device=ctx.device)
        null_path = os.path.join(work, "null.npy")
        np.save(null_path, null)
    state = {"work": work, "bg": bg, "mean": mean, "std": std, "null_path": null_path,
             "bases": bases, "lengths": lengths, "kept": []}
    ctx.inputs = {"m": int(bases.shape[0]), "k": cfg["k"],
                  "queries_per_call": int(ctx.traffic["queries_per_call"]),
                  "null_values": int(null.size)}
    # the warm calls run every step and shape of a timed call against a short
    # null: the load, float64 copy and sort of the full null are the same work
    # in every call, and nothing in them warms
    warm_null = np.array(null[:WARM_NULL])
    del null
    with ctx.span("setup.warm"):
        for i in range(int(ctx.traffic["warm_calls"])):
            _call(ctx, state, WARM_STREAM, i, null=warm_null)
    return state


def _call(ctx, state, stream: int, i: int, null=None):
    """One one-shot call: the null comes from its file unless ``null`` is given
    (the warm calls' short one); the background, its vectors and the queries
    are read from their files by ``find_pval`` itself."""
    from seekr_tpu_torch.stats import adj_pval, find_pval

    qb, ql = _batch(ctx, stream, i)
    qfa = os.path.join(state["work"], "queries.fa")
    corpus.write_fasta(qfa, corpus.to_strings(qb, ql), prefix="q")
    with ctx.span("find_pval"):
        fitres = np.load(state["null_path"]) if null is None else null
        p = find_pval(qfa, state["bg"], state["mean"], state["std"], ctx.config["k"],
                      fitres, log2=ctx.config["log2"], progress_bar=False,
                      device=ctx.device)
        del fitres
    with ctx.span("adj_pval"):
        adj = adj_pval(p, ctx.traffic["method"]) if p is not None else None
    return p, adj


def window(ctx, state):
    t_start = ctx.open_window()
    end = t_start + ctx.seconds
    if ctx.slice is not None:
        ctx.slice.start()
    calls, now = 0, t_start
    while now < end:
        p, adj = _call(ctx, state, QUERY_STREAM, calls)
        if p is None or adj is None:
            ctx.failed += 1
        else:
            state["kept"].append((calls, np.array(p.values), np.array(adj.values)))
        calls += 1
        now = time.perf_counter()
    if ctx.slice is not None:
        ctx.slice.stop()
        ctx.units_traced = calls
    window_s = now - t_start
    q, m = int(ctx.traffic["queries_per_call"]), ctx.inputs["m"]
    ctx.attempted = calls
    ctx.e2e["pval_cells_per_s"] = arith.window_rate((calls - ctx.failed) * q * m, window_s)
    ctx.counters["calls"] = calls


def check(ctx, state):
    """Largest |p - p_ref|, and largest |adj - adj_ref| scaled by rank / n
    (``arith.rank_scaled_err``), over every call of the window."""
    ref = reference(ctx.config)
    cfg = ctx.config
    dev = ctx.device
    c = ref.counts_per_kb(state.pop("bases"), state.pop("lengths"), cfg["k"])
    mean, std = ref.column_stats(c)
    bg = ref.standardize_rows(ref.log2_post(c, mean, std))
    del c
    null = torch.sort(ref.triu_values(ref.pearson(bg, bg))).values
    null = null[~torch.isnan(null)]
    worst_p = worst_adj = 0.0
    for i, p_prog, adj_prog in state.pop("kept"):
        qb, ql = _batch(ctx, QUERY_STREAM, i)
        qz = ref.standardize_rows(ref.log2_post(ref.counts_per_kb(qb, ql, cfg["k"]), mean, std))
        p_ref = ref.empirical_pvals(null, ref.pearson(qz, bg))
        adj_ref = ref.bh(p_ref.flatten()).reshape(p_ref.shape)
        got_p = torch.as_tensor(p_prog, device=dev).to(torch.float64)
        got_adj = torch.as_tensor(adj_prog, device=dev).to(torch.float64)
        worst_p = max(worst_p, arith.max_abs_err(got_p, p_ref))
        worst_adj = max(worst_adj, arith.rank_scaled_err(got_adj, adj_ref, p_ref))
    return {"pval_max_abs_err": worst_p, "adj_pval_scaled_err": worst_adj}
