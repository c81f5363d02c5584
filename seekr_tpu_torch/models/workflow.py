"""One-shot workflow: background -> counts -> Pearson -> p-values, on one card.

Port of ``seekr_tpu/models/workflow.py:45-246``.  The reference workflow is
five commands passing CSV files (norm_vectors -> kmer_counts -> pearson ->
find_dist -> find_pval -> adj_pval); this runs the same chain as one program,
each device stage feeding the next, and writes the artifacts once at the end:

  1. background fasta -> raw counts on the card (``count_kmers_smem``), counted
     once -> norm vectors (epilogue 1) and the normalized null set (epilogue 2)
  2. the background's self-Pearson (blocked GEMM, mirrored to exact symmetry)
     -> its upper triangle, subsampled by ``np.random.default_rng(seed)``: the
     empirical null
  3. the query fastas -> counts normalized by the background's vectors
  4. query1 x query2 Pearson
  5. empirical p-values (sorted null + searchsorted; float64, host)
  6. multiple-test correction (host), and optionally Leiden communities

``data_parallel``/``kmer_parallel`` build a device mesh and route both Pearson
stages through the data-sharded streamed GEMM
(``parallel.dist.stream_pearson_sharded``); ``coordinator``/``num_processes``/
``process_id`` first join the processes of a mesh across hosts
(``parallel.comm.init_distributed``).  Every process computes (the collectives
need all of them) and only process 0 writes: writers on a shared filesystem
would interleave the artifacts.

Scale: the p-value and corrected matrices are held in memory.  Above ~50k
transcripts use the streamed chain instead (``find_pval --stream -bo
pvals.npy``, then ``adj_pval pvals.npy <method> -bi``).
"""

from __future__ import annotations

import os

import numpy as np

from seekr_tpu_torch.io.fast_csv import LabeledMatrix, _quote, write_labeled_csv
from seekr_tpu_torch.io.stream import ArrayCollector
from seekr_tpu_torch.models.counter import KmerCounter
from seekr_tpu_torch.models.pearson import mirror_upper_inplace, pearson
from seekr_tpu_torch.ops.ecdf import empirical_pvals
from seekr_tpu_torch.ops.normalize import normalize_counts
from seekr_tpu_torch.ops.pearson import pearson_blocked
from seekr_tpu_torch.parallel.comm import process_index
from seekr_tpu_torch.stats.adj_pval import adj_pval
from seekr_tpu_torch.utils.adj import triu_values
from seekr_tpu_torch.utils.device import resolve_device
from seekr_tpu_torch.utils.logging import stage_timer

def _self_or_cross_pearson(c1, c2, device, mesh=None):
    """Self or cross Pearson: on ``mesh`` the data-sharded streamed GEMM, else
    the blocked GEMM for a self comparison and ``pearson`` for a cross one.
    A self result is mirrored to exact symmetry (the downstream 5-decimal
    symmetry test must see the upper-triangle case)."""
    if mesh is not None:
        from seekr_tpu_torch.parallel.dist import stream_pearson_sharded

        out = ArrayCollector()
        stream_pearson_sharded(mesh, c1, out, counts2=None if c2 is c1 else c2)
        sim = out.result()
    elif c2 is not c1:
        return pearson(c1, c2, device=device)
    else:
        sim = pearson_blocked(c1, c1, device=device)
    if c2 is c1:
        mirror_upper_inplace(sim)
    return sim


def _write_communities(path, headers, membership) -> None:
    """``pd.DataFrame({"Id": headers, "Community": membership}).to_csv(index=False)``."""
    with open(path, "w", newline="") as fh:
        fh.write("Id,Community\n")
        fh.writelines(f"{_quote(h)},{int(c)}\n" for h, c in zip(headers, membership))


def run_workflow(seq1file, seq2file=None, background=None, k=6,
                 log2="Log2.post", adj_method="fdr_bh", alpha=0.05,
                 outdir="seekr_out", subset_size=100_000, seed=None,
                 leiden=False, leiden_algo="RBERVertexPartition",
                 leiden_cutoff=0.0, leiden_resolution=1.0,
                 data_parallel=None, kmer_parallel=1, coordinator=None,
                 num_processes=None, process_id=None, device=None):
    """Full analysis in one call; returns a dict of results.

    ``seq2file=None`` compares ``seq1file`` with itself.  ``background`` (a
    fasta, required) gives the norm vectors and the empirical null.  Written to
    ``outdir``: ``mean_{k}mers.npy``, ``std_{k}mers.npy``, ``counts1.csv`` (and
    ``counts2.csv`` for a cross run), ``pearson.csv``, ``pvals.csv``,
    ``pvals_adjusted.csv`` and, with ``leiden=True`` on a self comparison,
    ``communities.csv`` (edges where r > ``leiden_cutoff``, the native engine,
    a fixed seed).  ``pvals`` and ``pvals_adjusted`` are ``LabeledMatrix``es.
    """
    from seekr_tpu_torch import native
    from seekr_tpu_torch.parallel.mesh import build_mesh_from_flags

    if background is None:
        raise ValueError("a background fasta is required (norm vectors + "
                         "empirical null)")
    dev = resolve_device(device)
    mesh = build_mesh_from_flags(data_parallel, kmer_parallel, coordinator=coordinator,
                                 num_processes=num_processes, process_id=process_id,
                                 device=dev)
    seq2file = seq2file or seq1file
    # './q.fa' and 'q.fa' (or a symlink) are still a self comparison
    if os.path.realpath(seq2file) == os.path.realpath(seq1file):
        seq2file = seq1file
    if leiden and leiden_algo not in native.ALGORITHMS:
        # before the expensive stages, not after them
        raise ValueError(f"leiden_algo must be one of {list(native.ALGORITHMS)}, "
                         f"got {leiden_algo!r}")
    writer = process_index() == 0
    if writer:
        os.makedirs(outdir, exist_ok=True)

    with stage_timer("workflow/background"):
        # the background is parsed and counted once; its two consumers differ
        # only in the normalization epilogue
        bkg = KmerCounter(background, k=k, log2=log2, silent=True, device=dev)
        raw = bkg._raw_counts_device()
        # epilogue 1: mean/std under the requested log2 mode; only the two
        # [4^k] vectors cross to the host
        _, mean_d, std_d = normalize_counts(raw, log2_mode=log2, mean=True, std=True)
        mean, std = mean_d.cpu().numpy(), std_d.cpu().numpy()
        if writer:
            np.save(os.path.join(outdir, f"mean_{k}mers.npy"), mean)
            np.save(os.path.join(outdir, f"std_{k}mers.npy"), std)
        # epilogue 2, the null set: Log2.post with the computed vectors, as
        # find_dist does; the counts stay on the card into the GEMM
        bkg_dev, _, _ = normalize_counts(raw, log2_mode="Log2.post", mean=mean, std=std)
        del raw
        sim_bkg = _self_or_cross_pearson(bkg_dev, bkg_dev, dev, mesh)
        del bkg_dev
        with stage_timer("workflow/null_sample"):
            null_sample = triu_values(sim_bkg)
            del sim_bkg
            if len(null_sample) > subset_size:
                rng = np.random.default_rng(seed)
                null_sample = rng.choice(null_sample, size=subset_size, replace=False)

    with stage_timer("workflow/counts"):
        c1 = KmerCounter(seq1file, mean=mean, std=std, k=k, log2=log2, silent=True,
                         device=dev)
        # the GEMM takes the device copy; the host copy (the CSV and the
        # returned dict) is fetched once
        c1_dev = c1.get_counts_device()
        c1.counts = c1_dev.cpu().numpy()
        headers1 = [h[1:] for h in c1.headers]
        if seq2file == seq1file:
            c2, c2_dev, headers2 = c1, c1_dev, headers1
        else:
            c2 = KmerCounter(seq2file, mean=mean, std=std, k=k, log2=log2, silent=True,
                             device=dev)
            c2_dev = c2.get_counts_device()
            c2.counts = c2_dev.cpu().numpy()
            headers2 = [h[1:] for h in c2.headers]

    with stage_timer("workflow/pearson", items=len(headers1) * len(headers2),
                     unit="cells"):
        sim = _self_or_cross_pearson(c1_dev, c2_dev, dev, mesh)
        del c1_dev, c2_dev

    with stage_timer("workflow/pvalues"):
        pvals = np.asarray(empirical_pvals(null_sample, sim), dtype=sim.dtype)
        pval_mat = LabeledMatrix(pvals, headers1, headers2)
        adj_mat = adj_pval(pval_mat, method=adj_method, alpha=alpha)

    membership = None
    if leiden:
        if c2 is not c1:
            print("leiden stage skipped: community detection needs a self "
                  "comparison (omit seq2file), not a cross-similarity of "
                  "two fastas.")
        else:
            with stage_timer("workflow/leiden", items=len(headers1), unit="nodes"):
                from seekr_tpu_torch.graph.kmer_leiden import leiden_membership

                gmat = np.array(sim, dtype=np.float64)  # one writable copy
                # kmer_leiden's threshold: r < cutoff -> 0, the diagonal -> 0,
                # the edges are the remaining r > 0 cells
                gmat[gmat < leiden_cutoff] = 0.0
                np.fill_diagonal(gmat, 0.0)
                membership = leiden_membership(LabeledMatrix(gmat, headers1, headers1),
                                               algo=leiden_algo, rs=leiden_resolution,
                                               setseed=True)
                del gmat

    if writer:
        with stage_timer("workflow/artifacts"):
            write_labeled_csv(os.path.join(outdir, "counts1.csv"), c1.counts, headers1,
                              c1.kmers)
            if c2 is not c1:
                write_labeled_csv(os.path.join(outdir, "counts2.csv"), c2.counts, headers2,
                                  c2.kmers)
            write_labeled_csv(os.path.join(outdir, "pearson.csv"), sim, headers1, headers2)
            pval_mat.to_csv(os.path.join(outdir, "pvals.csv"))
            if adj_mat is not None:
                adj_mat.to_csv(os.path.join(outdir, "pvals_adjusted.csv"))
            if membership is not None:
                _write_communities(os.path.join(outdir, "communities.csv"), headers1,
                                   membership)

    return {
        "mean": mean, "std": std, "null_sample": null_sample,
        "counts1": c1.counts, "counts2": c2.counts, "pearson": sim,
        "pvals": pval_mat, "pvals_adjusted": adj_mat,
        "communities": membership,
    }
