#!/usr/bin/env python3
"""Check the seekr_tpu_torch port's main path and its layers on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one NVIDIA card, ``nvcc`` and
PyTorch built for CUDA.  It builds the CUDA kernels from ``seekr_tpu_torch/csrc``
and runs the phases below, each a function of (device, scale, state), each
raising at its first failed check.  It checks; it does not measure: the port's
speed is measured by the benchmark in ``benchmarks/`` (``BENCHMARK.json``).  The
one exception is phase 5, which times each hand-written kernel alone.

1. environment: torch and CUDA versions, ``nvcc --version``, the card's name and
   power limit, the kernel build (with ptxas' register and spill lines), and the
   host C++ library's g++ build (its path);
2. every count kernel against its plain PyTorch version (``count_torch``) at
   k = 1..12 and 15, with N bases, short, zero-length and padded rows, and at
   k >= 8 a row whose windows hit both edges of the hi-blocked kernel's slices,
   scaled and raw, flat and unflattened; and at k = 9 two rows of one repeated
   code whose bins pass 65,535: bitwise equal (``torch.equal``);
3. the main path through ``SeekrPipeline(k=6, log2="Log2.post").forward`` on a
   synthetic stand-in of the reference's default background corpus (12,996
   GENCODE vM25 lncRNAs: here 13,000 transcripts with lognormal lengths, median
   about 1.4 kb, capped at 4,096): r finite and within 1e-4 of a float64
   recomputation of normalize + Pearson from the kernel's counts; the self
   Gram's route (``ops.pearson.gram_routes``: the split TF32 product by
   default) is printed; on a card the normalize chain and the row
   standardization must take the fused route (``ops.normalize.routes``,
   ``ops.pearson.standardize_routes``) with one launch of each epilogue kernel
   (``csrc/epilogue.cu``: column statistics, normalize, row statistics,
   standardize-split) for the one column block of k = 6, and the self Gram one
   launch of the symmetric GEMM (``csrc/sym_gemm.cu``) over the 5,253 tiles of
   the upper triangle (``ops.pearson.sym_gemm``); r exactly symmetric, bit for
   bit;
4. the same corpus through ``KmerCounter(fasta).get_counts()`` and ``pearson``
   (the blocked path): exactly symmetric, within 1e-4 of phase 3; a FASTA with
   two transcripts past the long-sequence threshold against the numpy oracle;
   ``KmerCounter(k=9)`` (the large-k kernel) against the numpy oracle; and the
   counter's counts with the Python parse and encode forced, bitwise those of
   the native parse and encode;
5. each kernel alone at its main-path shapes, bitwise ``count_torch`` there:
   its device time (CUDA events; and per launch), its bound (the bytes it must
   move at the HBM rate, and the share of it reached), the plain version's time
   and a library yardstick; for the hi-blocked kernel also a write-only pass
   over the same output, and its time and bound at phase 2's widest k; and
   each epilogue kernel alone on the forward's operand, [13,000 x 4,096] at
   k = 6 and one 4,096-column block of the k = 9 buffer: its time, its bound
   (the bytes it must move at the HBM rate), its plain twin's time and the
   torch chain's launches it replaces, and its largest difference from the
   twin, absolute and in float32 ulp: the statistics within one ulp, the
   shift and each element bitwise given the kernel's statistics, else the
   run fails; and the symmetric GEMM alone at the same two shapes (the k = 9
   block a middle one, adding into r): its time, its bound (its three TF32
   products over the upper triangle at the TF32 peak), its twin's time, and the
   cuBLAS composition it replaced (``hi lo^T``, ``X + X^T``, eight 512-column
   ``addmm_``, the divide; at the k = 9 block that block's ``addmm_``), r exactly
   symmetric and within 1e-5 of float64, else the run fails;
6. the statistics chain at k = 4 on the same corpus, in a temporary working
   directory: ``find_dist`` (a 100,000-value background sample),
   ``fit_distributions`` (norm, expon, rayleigh, uniform), ``find_pval`` for
   the first 1,000 transcripts against all 13,000 (empirical and fitted) and
   for the first 2,048 against themselves, ``adj_pval(fdr_bh)`` on each,
   ``pearson_pairs`` on 100,000 random pairs, and the six CLI commands in
   process on the first 1,000 transcripts.  Checked: r within 1e-4 of a
   float64 recomputation; empirical p-values equal to the float64 ECDF away
   from background ties, and against a plain exceedance count; every fitted
   model back; fitted p-values within 1e-4 of scipy's cdf; the self matrix
   exactly symmetric and corrected on its upper triangle; adj_pval within
   1e-12 of a direct float64 Benjamini-Hochberg; pearson_pairs within 1e-5 of
   the blocked r-matrix; the CLI's artifacts.  And each host path against the
   Python/numpy path the host C++ library replaced (``SEEKR_TPU_HOST_SORT=numpy``,
   the Python parse and writer): the counts, the corrections and the 13 M-cell
   CSV bytes equal, BH on the card (``multipletests`` and ``adj_pval``'s
   default there) the same bytes as both host routes, and the ECDF at the
   benchmark's pval sizes (all 84.5 M pairs' r as the null, 500 query rows) on
   the card bitwise the host's;
7. the warm-resident service (``serve.SeekrService``) at seekr_tpu's serving
   benchmark size (``bench.py:410-475``): the corpus as 13,000 targets at k = 6,
   Log2.post, the width padded to 13,056 rows, the norm vectors and a
   100,000-value empirical background from ``find_dist``; load, warmup, Q=1
   ``sim`` and Q=128 ``topk=10`` queries of 512-2,048 bases, a burst of 16
   threads x 8 queries, growth within and across the width quantum, a snapshot
   saved and loaded, a round trip over a UNIX socket.  Checked: sim within 1e-4
   of float64; top-k equal to a stable sort of sim; empirical p-values equal to
   ``SortedBackground``; the segmented normalize bitwise equal to
   ``normalize_counts`` per request; every burst query answered, within 1e-6
   of the serial answers; existing scores bitwise across a grow within the
   quantum (in place) and after a snapshot reload, within 1e-5 across it;
   socket answers equal to in-process ones;
8. communities (``graph.kmer_leiden``) at the reference's background size:
   13,000 k = 6 transcripts in 260 planted families of 50 (each member its
   founder with 10% of its bases substituted), norm vectors from the corpus,
   ``RBERVertexPartition``, ``setseed``, cutoff 0.2; dense, streamed with its
   Gephi export, and the dense export on the first 500; the within- and
   across-family r quantiles are printed.  Checked: the host library is the
   port's own build; the similarity within 1e-4 of float64; the edge set equal
   to float64's but for pairs within 1e-4 of the cutoff; the 260 families found
   exactly; two seeded runs identical; the streamed edges and partition equal
   to the dense ones; the exports' rows;
9. the one-shot workflow and the tools around it, at k = 6 in a temporary
   working directory.  ``run_workflow`` with phase 3's corpus as the background
   (a 100,000-value null) on the first 2,600 of phase 8's family transcripts
   with the Leiden stage (cutoff 0.2), and the CLI's ``pipeline`` for the first
   1,000 transcripts against all 13,000, held to the port's stepwise chain
   (norm vectors, counts within 1e-5, r within 1e-4 of float64, p-values equal
   away from null ties, adjusted within 1e-12 of a direct BH, the null the
   seeded draw of float64 r, the 52 families exactly, every artifact present).
   Then ``find_pval --stream -bo`` for 13,000 x 13,000 and 1,000 x 13,000,
   and ``adj_pval_stream`` on each beside the in-memory ``adj_pval`` (fdr_bh;
   on the cross matrix also bonferroni, holm, fdr_by; and fdr_bh on its first
   50 rows with ``max_bucket_pairs`` 2,000, which forces the tie-mass
   segments): the .npy bitwise and the CSV byte-equal.  ``DomainPearson`` (8
   queries, 1,000 targets in windows of 1,000 every 100, the corpus as
   reference): r within 1e-4 of a float64 recomputation from ``count_torch``'s
   counts, percentiles equal away from ties, the window labels.
   ``CountsWeighter`` on the corpus' k = 5 counts with 64 seeded PWMs and the
   repo's fixture PWM, within 1e-9 relative of ``counts @ weights`` built
   apart.  The data tools on the corpus with GENCODE-style headers and a seeded
   GTF: ``canonical_gencode`` and ``filter_gencode`` against a direct filter,
   ``gen_rand_rnas -k 2`` on 1,000 transcripts with every 2-mer count kept,
   bitwise.  ``doctor`` in a subprocess exits 0 and names the card;
10. the plots' and graphs' compute, at the reference's background size.  The
   dendrogram's path on the k = 6 Log2.post profiles of phase 8's 13,000 family
   transcripts (counted on the card), rows [13,000 x 4,096] and columns: the
   device pdist (routed there by ``use_device_pdist``), ``linkage`` (complete)
   and the leaf order.  Checked: the entry path's linkage equal to the one
   built step by step; every row distance within 1e-5 of a float64 pdist on
   the card, NaN where NaN (the column distances, each a sum over 13,000
   values, within seekr_tpu's budget against scipy, rtol 1e-4 / atol 1e-5);
   the first 1,000 rows within rtol 1e-4 / atol 1e-5 of scipy's pdist, and
   their leaf order equal to float64's unless two float64 merge heights lie
   within 1e-5; the adjusted Rand index of 260 clusters against the planted
   families is printed.  The heatmap's row and column orders of phase 3's
   4,096 x 4,096 self-Pearson block, its pdist held to float64 likewise.  The
   barplots' counts of phase 3's corpus (on the card, within 1e-5 of float64)
   and their orders (count: the first 10 transcripts; mean and sd: all
   13,000), equal to float64's away from 1e-5 ties.  The textplots' word
   coordinates of 10 words on phase 4's two long transcripts, equal to a
   window scan.  ``visualize_distro``'s streamed statistics of phase 3's
   matrix (mirrored, as an ``.npy``): n exact, mean and sd within 1e-9
   relative of float64, the median within one fine bin of the middle value.
   ``help`` in a fresh process: 25 sections.  The drawing entry points draw
   where matplotlib, seaborn and networkx are installed, and otherwise raise
   ``ModuleNotFoundError`` naming the missing one (the card's machine has
   none; the drawing is held to seekr_tpu on the CPU by
   ``tests/test_torch_viz.py`` and its neighbours);
11. the device mesh in one process (``seekr_tpu_torch.parallel``) over every
   visible card, or four shards of the one card (``[cuda:0] * 4``: every line
   of the sharded code and its kernels, but no copy between cards).
   ``distributed_pipeline`` on phase 3's corpus at k = 6 (six runs),
   ``flat=False`` and the norm-vector mode once each;
   ``distributed_norm_stats``; a (2, 2) grid at k = 9 on 2,048 rows
   (``count_kmers_hiblocked`` per data shard, 2.1 GB of counts);
   ``count_long_sequence`` on one 4 Mb transcript; ``stream_pearson_sharded``
   on the 13,000^2 self matrix and 1,000 x 13,000; ``find_dist`` (phase 6's
   seeded draw, k = 4), ``find_pval`` (cross and self) and ``kmer_leiden`` (the
   first 2,600 of phase 8's family transcripts) with ``data_parallel`` (below
   two cards it resolves to the shards of the one card, through
   ``data_parallel_on_shards``); the CLI's ``find_dist -dp`` (on one card it
   must fail with seekr_tpu's "requested 4 devices ... have 1"); the service
   with ``mesh=`` on phase 7's targets beside the single-card service (Q=1
   ``sim`` and Q=128 ``topk=10``, growth within and across the width quantum,
   a snapshot); a checkpoint of the sharded 13,000 x 4,096 counts restored
   onto the (2, 2) grid.  Checked: counts per shard bitwise; normalized
   counts, mean and std within rtol 1e-4 / atol 1e-5 and r within 1e-4 of the
   single device; at k = 9, the grid's r and the single path's within 1e-4 of
   float64 (the single path as one cuBLAS product, as before
   ``ops.pearson.gram`` cut long contractions into 4,096-column pieces, is
   printed beside them); the long sequence bitwise a whole-row
   ``count_torch``; the streamed tiles within 1e-4; find_dist and find_pval
   within 1e-5 of the single card, the self p-values exactly symmetric; the
   Leiden membership equal to the single card's and the planted families; the
   service's sim within 1e-6 and its top-k equal away from near ties,
   bitwise across a grow within the quantum and a snapshot; the checkpoint
   bitwise;
12. the mesh across processes: two processes joined by ``torch.distributed``
   on 127.0.0.1 (one per card where there are two, each seeing only its own,
   NCCL for the data; else both on the one card, gloo staged through pinned
   host memory), each a ``chip_smoke.py --child`` process; the backend of each
   process group is printed.  (a) ``distributed_pipeline`` on phase 3's corpus
   at k = 6, six runs in each process; each process holds its shards against
   its own one-process mesh of the same grid (counts, mean, std bitwise, r
   within 1e-6) and ``SeekrPipeline.forward`` (1e-4).  (b) The CLI's
   ``serve -dp 2 --num_processes 2 --coordinator`` on phase 7's 13,000
   targets: Q=1 ``sim`` and Q=128 ``topk=10`` socket requests beside the
   single-card service behind a socket of its own (sim within 1e-6, top-k
   equal away from near ties), one ``add_targets``, a shutdown after which
   both processes exit 0.  (c) A pod whose follower is killed: the client's
   "unresponsive" error within the watchdog's 10 s and a margin, later
   requests failing within 5 s, the leader exiting 0.  (d) The CLI's
   ``pipeline -dp 2 --num_processes 2`` (1,000 queries, a 2,048-transcript
   background): only process 0 writes, its artifacts byte-equal to one process
   holding the same mesh, the counts and norm vectors to the single card, r
   within 1e-5 of it.

Launch counts are set to 0 just before phases 3, 4, 6, 7, 8, 9 (the workflow,
``domain_pearson`` and the PWM counts), 10 (the profiles and the barplots'
counts) and each main-path section of phase 11 drive the main path and read just
after; in phase 12 each child process counts from 0 over its main path and
prints its counts on its JSON line, which are added to the main path's (the
count kernels' only: the children's epilogue launches are not counted).  The
run fails if a kernel of the path was not launched, phases 9 and 10
fail if their counting did not launch ``count_kmers_smem``, phase 11 if its
pipeline did not launch ``count_kmers_smem`` on every shard in every run or its
k = 9 grid ``count_kmers_hiblocked`` on every data shard, and phase 12 if the
processes of (a), (b) or (d) did not launch ``count_kmers_smem``.
The last lines are the ``kernels`` JSON line (phase 5's rows), the card's
``nvidia-smi`` line and ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero; without a CUDA card the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
PIPELINE_K = 6
LARGE_K = 9
WIDE_K_CASES = ((11, 8), (12, 8), (15, 1))  # (k, rows) of the widest comparisons
ONE_CODE_WINDOWS = (65_536, 65_535)  # windows of the two one-code rows at k = LARGE_K
SOURCE = "seekr_tpu_torch/csrc/count_kmers.cu"
REPLACES = {  # kernel -> the TPU kernel body it replaces
    "count_kmers_smem": "seekr_tpu/ops/count_pallas.py:67",
    "count_kmers_hiblocked": "seekr_tpu/ops/count_pallas.py:125",
}
EPILOGUE_SOURCE = "seekr_tpu_torch/csrc/epilogue.cu"
EPILOGUE_REPLACES = "none: seekr_tpu's normalize and Pearson are XLA; added for the H100"
# bytes each epilogue kernel must move per element of its block: column and
# row statistics read it, normalize reads and writes it, standardize-split
# reads it and writes both TF32 halves
EPILOGUE_BYTES = {"epilogue_column_stats": 4, "epilogue_normalize": 8,
                  "epilogue_row_stats": 4, "epilogue_standardize_split": 12}
SYM_GEMM = "sym_split_gemm"
SYM_GEMM_SOURCE = "seekr_tpu_torch/csrc/sym_gemm.cu"
SYM_GEMM_REPLACES = "none: seekr_tpu's Pearson Gram is XLA; added for the H100"
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet)
DIGIT2CHAR = np.frombuffer(b"AGTCN", dtype=np.uint8)


@dataclass(frozen=True)
class Scale:
    corpus_m: int        # transcripts of the main-path corpus
    corpus_cap: int      # longest transcript, and the pipeline's padded length
    kernel_m: int        # rows of a kernel comparison at k <= 8
    kernel_m_big: int    # rows of a kernel comparison at k = 9, 10
    kernel_lmax: int     # padded length of a kernel comparison
    large_k_m: int       # transcripts of the k = 9 counter run
    long_lengths: tuple  # lengths of the two long transcripts of phase 4
    reps: int            # launches a phase 5 timing averages over
    stats_subset: int    # r-values of find_dist's background sample
    stats_query: int     # transcripts of find_pval's query (and of the CLI runs)
    stats_self: int      # transcripts of find_pval's self comparison
    stats_pairs: int     # pairs through pearson_pairs
    stats_plain_cells: int  # p-value cells held against a plain exceedance count
    serve_rounds: int    # interleaved rounds of the service's traffic
    serve_q1: int        # Q=1 sim queries per round
    serve_big: int       # large top-k queries per round
    serve_big_q: int     # rows of a large query
    serve_burst: tuple   # (threads, queries each) of the coalesced burst
    serve_grow: tuple    # rows added within the width quantum, then across it
    leiden_k: int        # k of the community run
    leiden_families: int  # planted families of the community run
    leiden_members: int  # transcripts of each family
    leiden_dense_export: int  # transcripts of the dense Gephi export
    wf_k: int            # k of the workflow, domain_pearson and adj_pval -bi runs
    wf_families: int     # phase 8 families whose members are the self run's queries
    adj_tie_cap: int     # max_bucket_pairs of the tie-mass adj_pval -bi case
    adj_tie_rows: int    # head rows of the cross p-values in that case
    dom_queries: int     # queries of domain_pearson
    dom_targets: int     # targets of domain_pearson, tiled into windows
    dom_window: tuple    # (window, slide) of domain_pearson
    pwm_count: int       # random PWMs besides the fixture
    pwm_k: int           # k of the counts the PWMs score
    rand_m: int          # transcripts shuffled by gen_rand_rnas
    plot_check_rows: int  # head rows of the profiles held against scipy's pdist
    heatmap_rows: int    # edge of phase 3's self-Pearson block the heatmap clusters
    mesh_kmer_m: int     # rows of the kmer-axis mesh run at k = LARGE_K
    mesh_long_len: int   # bases of the long transcript counted sequence-parallel
    mesh_reps: int       # runs of the mesh pipeline after its first


FULL = Scale(corpus_m=13_000, corpus_cap=4096, kernel_m=2048, kernel_m_big=256,
             kernel_lmax=4096, large_k_m=1024, long_lengths=(20_000, 40_000), reps=10,
             stats_subset=100_000, stats_query=1000, stats_self=2048, stats_pairs=100_000,
             stats_plain_cells=4096, serve_rounds=3, serve_q1=10, serve_big=3,
             serve_big_q=128, serve_burst=(16, 8), serve_grow=(40, 300), leiden_k=6,
             leiden_families=260, leiden_members=50, leiden_dense_export=500, wf_k=6,
             wf_families=52, adj_tie_cap=2_000, adj_tie_rows=50, dom_queries=8,
             dom_targets=1000, dom_window=(1000, 100), pwm_count=64, pwm_k=5, rand_m=1000,
             plot_check_rows=1000, heatmap_rows=4096, mesh_kmer_m=2048,
             mesh_long_len=4_000_000, mesh_reps=5)
TINY = Scale(corpus_m=96, corpus_cap=1024, kernel_m=24, kernel_m_big=6,
             kernel_lmax=600, large_k_m=12, long_lengths=(16_500, 17_000), reps=2,
             stats_subset=600, stats_query=16, stats_self=24, stats_pairs=500,
             stats_plain_cells=200, serve_rounds=2, serve_q1=3, serve_big=1,
             serve_big_q=16, serve_burst=(4, 2), serve_grow=(40, 200), leiden_k=4,
             leiden_families=6, leiden_members=8, leiden_dense_export=20, wf_k=4,
             wf_families=3, adj_tie_cap=2, adj_tie_rows=16, dom_queries=2, dom_targets=8,
             dom_window=(300, 50), pwm_count=4, pwm_k=3, rand_m=16, plot_check_rows=20,
             heatmap_rows=40, mesh_kmer_m=16, mesh_long_len=20_000, mesh_reps=2)


def log(*parts) -> None:
    print(*parts, flush=True)


def is_cuda(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def sync(device) -> None:
    import torch

    if is_cuda(device):
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events over ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@contextmanager
def python_host_paths():
    """The host paths as they ran before the C++ library, the reference of the
    native ones: the Python FASTA parse and encode (the native parse gate
    answers no) and the numpy sorts (``SEEKR_TPU_HOST_SORT=numpy``).
    The Python CSV writer is ``io.fast_csv.labeled_csv_bytes``, called apart."""
    import os

    from seekr_tpu_torch.io import encode

    gate, env = encode._native_parse_is_safe, os.environ.get("SEEKR_TPU_HOST_SORT")
    encode._native_parse_is_safe = lambda path: False
    os.environ["SEEKR_TPU_HOST_SORT"] = "numpy"
    try:
        yield
    finally:
        encode._native_parse_is_safe = gate
        if env is None:
            del os.environ["SEEKR_TPU_HOST_SORT"]
        else:
            os.environ["SEEKR_TPU_HOST_SORT"] = env


# -- data ------------------------------------------------------------------

def make_corpus(m: int, cap: int, seed: int):
    """Synthetic transcripts: digits [m, cap] int8 (4 = N / pad) + lengths [m].

    Lognormal lengths with median 1.4 kb, between 200 (the GENCODE lncRNA
    floor) and ``cap``; uniform bases with one N per ~2,000.
    """
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(np.log(1400.0), 0.6, size=m), 200, cap).astype(np.int32)
    bases = rng.integers(0, 4, size=(m, cap), dtype=np.int8)
    bases[rng.random((m, cap)) < 5e-4] = 4
    bases[np.arange(cap)[None, :] >= lengths[:, None]] = 4
    return bases, lengths


def to_strings(bases, lengths):
    return [DIGIT2CHAR[row[:n]].tobytes().decode() for row, n in zip(bases, lengths)]


def write_fasta_file(path, seqs):
    from seekr_tpu_torch.io.fasta import write_fasta

    write_fasta(str(path), [f"t{i}" for i in range(len(seqs))], seqs)


def slice_edge_row(rng, k: int, lpad: int):
    """A full row of digits whose first windows have the codes at both edges of
    the hi-blocked kernel's slices of S bins (``hiblock_plan``): 0, S - 1, S,
    2S - 1, 2S, the last slice's first bin and its neighbour, and the row's last
    bin, each followed by an N; random digits after them."""
    from seekr_tpu_torch.ops.count_cuda import hiblock_plan

    n_bins = 1 << (2 * k)
    s = hiblock_plan(k)[0]
    codes = [0, s - 1, s, 2 * s - 1, 2 * s, n_bins - s - 1, n_bins - s, n_bins - 1]
    row = rng.integers(0, 4, size=lpad, dtype=np.int8)
    for i, code in enumerate(codes):
        pos = i * (k + 1)
        if pos + k >= lpad:
            break
        row[pos:pos + k] = [(code >> (2 * (k - 1 - j))) & 3 for j in range(k)]
        row[pos + k] = 4
    return row


def one_code_case(k: int):
    """Two rows whose windows all share one code, so one bin counts every window:
    all A (code 0, the first slice) with ``ONE_CODE_WINDOWS[0]`` windows, and all
    C (code 4^k - 1, the last slice) with ``ONE_CODE_WINDOWS[1]``."""
    lengths = np.array([n + k - 1 for n in ONE_CODE_WINDOWS], dtype=np.int32)
    bases = np.full((2, int(lengths.max())), 3, dtype=np.int8)  # 3 = C
    bases[0] = 0  # A
    bases[1, lengths[1]:] = 4
    return bases, lengths


def kernel_case(rng, m: int, lmax: int, k: int):
    """Count-kernel inputs with every edge: N bases, a zero-length row, a row
    shorter than k, a full-width row, an all-N row, padded ragged rows, and at
    k >= 8 a last row of slice-edge windows (``slice_edge_row``)."""
    from seekr_tpu_torch.ops.count_cuda import SMEM_MAX_K

    lengths = rng.integers(min(512, lmax // 2), lmax + 1, size=m).astype(np.int32)
    bases = rng.integers(0, 4, size=(m, lmax), dtype=np.int8)
    bases[rng.random((m, lmax)) < 0.01] = 4
    lengths[:3] = (0, k - 1, lmax)[:m]
    bases[3:4, :] = 4
    bases[np.arange(lmax)[None, :] >= lengths[:, None]] = 4
    if k > SMEM_MAX_K:
        bases[-1] = slice_edge_row(rng, k, lmax)
        lengths[-1] = lmax
    return bases, lengths


# -- phases ----------------------------------------------------------------

def phase_env(device, scale, state):
    import torch

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    from seekr_tpu_torch import native

    state["native_library"] = native.library_path()  # g++ at first use: no fallback
    log(f"host library (g++): {state['native_library']}")
    if not is_cuda(device):
        log("device: cpu (rehearsal; no kernel is built)")
        return
    from seekr_tpu_torch.utils import build

    nvcc = build.find_nvcc()
    log(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       check=True).stdout.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    state["smi"] = smi[torch.device(device).index or 0]
    log(f"card: {state['smi']}  ({torch.cuda.get_device_name(device)})")
    build.load_library()
    log("\n".join(line for line in build.build_log().splitlines()
                  if "registers" in line or "spill" in line or "Compiling" in line))


def phase_kernels(device, scale, state):
    """Both CUDA kernels against count_torch on the card, bitwise."""
    if not is_cuda(device):
        log("kernel comparisons: skipped on the CPU")
        return
    import torch

    from seekr_tpu_torch.ops.count import count_torch
    from seekr_tpu_torch.ops.count_cuda import count_kmers_cuda, kernel_for

    rng = np.random.default_rng(state["seed"] + 1)
    cases = ([(k, kernel_case(rng, scale.kernel_m, scale.kernel_lmax, k)) for k in range(1, 9)]
             + [(k, kernel_case(rng, scale.kernel_m_big, scale.kernel_lmax, k))
                for k in (9, 10)]
             + [(k, kernel_case(rng, m, scale.kernel_lmax, k)) for k, m in WIDE_K_CASES]
             + [(LARGE_K, one_code_case(LARGE_K))])
    for k, (b, n) in cases:
        bt = torch.as_tensor(b, device=device)
        nt = torch.as_tensor(n, device=device)
        # a 4 GB output row at the top k: flat only
        flats = (True,) if k == 15 else (True, False)
        worst = 0.0
        for scaled in (True, False):
            for flat in flats:
                want = count_torch(bt, nt, k, scaled=scaled, flat=flat)
                got = count_kmers_cuda(bt, nt, k, scaled=scaled, flat=flat)
                sync(device)
                if got.shape != want.shape or not torch.equal(got, want):
                    raise AssertionError(
                        f"{kernel_for(k)} differs from count_torch at k={k} "
                        f"{tuple(b.shape)} scaled={scaled} flat={flat}: max abs "
                        f"{(got - want).abs().max().item()}")
                worst = max(worst, (got - want).abs().max().item())
                del got, want
        record_err(state, kernel_for(k), worst)
        log(f"k={k:2d} {kernel_for(k)} [m, Lpad]={list(b.shape)}: torch.equal, "
            f"max abs diff {worst}")


def record_err(state, name, err):
    errs = state.setdefault("max_abs_err", {})
    errs[name] = max(errs.get(name, 0.0), float(err))


def reset_sym_gemm():
    from seekr_tpu_torch.ops import sym_gemm_cuda

    sym_gemm_cuda.counts.update(dict.fromkeys(sym_gemm_cuda.counts, 0))


def reset_launches():
    """Set every kernel's launch count to 0 (a main-path section starts)."""
    from seekr_tpu_torch.ops import count_cuda, epilogue_cuda

    count_cuda.reset_launches()
    epilogue_cuda.reset_launches()
    reset_sym_gemm()


def read_launches(state, phase):
    """Add the launches made since the last reset to the main-path counts."""
    from seekr_tpu_torch.ops import count_cuda, epilogue_cuda, sym_gemm_cuda

    main = state.setdefault("launches", dict.fromkeys(count_cuda.KERNELS, 0))
    for name, n in count_cuda.launches.items():
        main[name] += n
    epilogue = state.setdefault("epilogue_launches", dict.fromkeys(epilogue_cuda.KERNELS, 0))
    for name, n in epilogue_cuda.launches.items():
        epilogue[name] += n
    state[SYM_GEMM] = state.get(SYM_GEMM, 0) + sym_gemm_cuda.counts["launches"]
    log(f"{phase}: kernel launches {dict(count_cuda.launches)} "
        f"{dict(epilogue_cuda.launches)} {SYM_GEMM} {dict(sym_gemm_cuda.counts)}")
    epilogue_cuda.reset_launches()  # sections the count kernels' resets miss stay out
    reset_sym_gemm()


def f64_reference(raw, ncols):
    """Log2.post normalize + Pearson in float64 from raw counts."""
    import torch

    c = raw.to(torch.float64)
    c = c - c.mean(dim=0)
    c = c / c.std(dim=0, correction=0)
    c = c + c.min().abs()
    c = torch.log2(c + 1.0)
    c = c - c.mean(dim=1, keepdim=True)
    c = c / c.std(dim=1, keepdim=True, correction=0)
    return (c @ c.T) / ncols


def phase_pipeline(device, scale, state):
    """Main path, pipeline entry: SeekrPipeline(k=6, Log2.post).forward."""
    import torch

    from seekr_tpu_torch.models.pipeline import SeekrPipeline
    from seekr_tpu_torch.ops import epilogue_cuda
    from seekr_tpu_torch.ops import normalize as normalize_ops
    from seekr_tpu_torch.ops import pearson as pearson_ops
    from seekr_tpu_torch.ops import sym_gemm_cuda
    from seekr_tpu_torch.ops.count import count_graph

    bases, lengths = make_corpus(scale.corpus_m, scale.corpus_cap, state["seed"])
    state["corpus"] = (bases, lengths)
    m = bases.shape[0]
    log(f"corpus: m={m}, Lpad={bases.shape[1]}, {int(lengths.sum())} bases, "
        f"median length {int(np.median(lengths))}")
    pipe = SeekrPipeline(k=PIPELINE_K, log2="Log2.post", device=device)
    bt = torch.as_tensor(bases, device=device)  # set-up: one upload of the corpus
    nt = torch.as_tensor(lengths, device=device)

    def taken(counts, before):
        return sorted(k for k, v in counts.items() if v != before[k])

    reset_launches()
    before = [dict(c) for c in (pearson_ops.gram_routes, normalize_ops.routes,
                                pearson_ops.standardize_routes)]
    sim = pipe.forward(bt, nt)
    sync(device)
    routes = [taken(c, b) for c, b in zip((pearson_ops.gram_routes, normalize_ops.routes,
                                           pearson_ops.standardize_routes), before)]
    epilogue = dict(epilogue_cuda.launches)
    sym = dict(sym_gemm_cuda.counts)
    read_launches(state, "pipeline")

    out = {"phase": "pipeline", "m": m, "k": PIPELINE_K, "self_gram_route": routes[0],
           "normalize_route": routes[1], "standardize_route": routes[2],
           "epilogue_launches": epilogue, "sym_gemm": sym}
    # one column block at k = 6: one launch of each epilogue kernel on a card, and
    # one of the symmetric GEMM over the upper triangle's tiles
    want = ((["fused"], ["fused"], dict.fromkeys(epilogue_cuda.KERNELS, 1),
             {"launches": 1, "tiles": sym_gemm_cuda.tiles_of(m)}) if is_cuda(device)
            else (["torch"], ["torch"], dict.fromkeys(epilogue_cuda.KERNELS, 0),
                  {"launches": 0, "tiles": 0}))
    if (routes[1], routes[2], epilogue, sym) != want:
        raise AssertionError(f"the forward's epilogue and Gram: routes {routes[1]}, {routes[2]}, "
                             f"launches {epilogue} and {sym}, where {want} was due")
    if sim.shape != (m, m) or not bool(torch.isfinite(sim).all()):
        raise AssertionError(f"pipeline output: shape {tuple(sim.shape)}, "
                             f"finite {bool(torch.isfinite(sim).all())}")
    bits = sim.view(torch.int32)
    out["symmetric"] = bool(torch.equal(bits, bits.T))
    if is_cuda(device) and not out["symmetric"]:  # the CPU's float32 product promises no mirror
        raise AssertionError("the forward's r is not exactly symmetric")
    raw = count_graph(bt, nt, PIPELINE_K)
    ref = f64_reference(raw, raw.shape[1])
    err = (sim.to(torch.float64) - ref).abs().max().item()
    out["max_abs_vs_f64"] = err
    log(json.dumps(out))
    if not err <= 1e-4:
        raise AssertionError(f"pipeline vs float64 recomputation: max abs {err} > 1e-4")
    state["sim"] = sim.cpu().numpy()
    del sim, ref, raw


def phase_counter(device, scale, state):
    """Main path, counter entry: KmerCounter(fasta).get_counts() + pearson."""
    from seekr_tpu_torch.models.counter import KmerCounter
    from seekr_tpu_torch.models.pearson import pearson
    from seekr_tpu_torch.ops.count import count_kmers_host

    bases, lengths = state["corpus"]
    seqs = to_strings(bases, lengths)
    rng = np.random.default_rng(state["seed"] + 2)
    long_seqs = seqs[:30]
    for pos, n in zip((7, 19), scale.long_lengths):
        long_seqs.insert(pos, DIGIT2CHAR[rng.integers(0, 4, size=n)].tobytes().decode())
    large_k_seqs = seqs[:scale.large_k_m]
    raw = dict(mean=False, std=False, log2="Log2.none", silent=True, device=device)

    with tempfile.TemporaryDirectory() as tmp:
        fa = Path(tmp) / "corpus.fa"
        fa_long = Path(tmp) / "long.fa"
        fa_large_k = Path(tmp) / "large_k.fa"
        write_fasta_file(fa, seqs)
        write_fasta_file(fa_long, long_seqs)
        write_fasta_file(fa_large_k, large_k_seqs)

        reset_launches()
        counts = KmerCounter(str(fa), k=PIPELINE_K, silent=True, device=device).get_counts()
        sim = pearson(counts, counts, device=device)
        long_counts = KmerCounter(str(fa_long), k=PIPELINE_K, **raw).get_counts()
        large_k_counts = KmerCounter(str(fa_large_k), k=LARGE_K, **raw).get_counts()
        read_launches(state, "counter")
        # the Python parse and encode on the same file (not counted): the
        # native path's counts bit for bit
        with python_host_paths():
            python_counts = KmerCounter(str(fa), k=PIPELINE_K, silent=True,
                                        device=device).get_counts()

    m = len(seqs)
    out = {"phase": "counter", "m": m,
           "counts_bitwise_python_host": python_counts.tobytes() == counts.tobytes()}
    if not out["counts_bitwise_python_host"]:
        raise AssertionError("the counter's native parse and encode give other counts "
                             "than the Python ones")
    if sim.shape != (m, m) or not np.isfinite(sim).all():
        raise AssertionError(f"counter pearson: shape {sim.shape}, finite "
                             f"{np.isfinite(sim).all()}")
    if not np.array_equal(sim, sim.T):
        raise AssertionError("counter pearson self-similarity is not exactly symmetric")
    out["max_abs_vs_pipeline"] = float(np.abs(sim - state["sim"]).max())
    oracle = count_kmers_host(long_seqs, PIPELINE_K)
    out["long_max_rel"] = float(np.abs(long_counts - oracle).max() / np.abs(oracle).max())
    np.testing.assert_allclose(long_counts, oracle, rtol=1e-4, atol=1e-4)
    oracle = count_kmers_host(large_k_seqs, LARGE_K)
    np.testing.assert_allclose(large_k_counts, oracle, rtol=1e-4, atol=1e-4)
    out["large_k_shape"] = list(large_k_counts.shape)
    log(json.dumps(out))
    if not out["max_abs_vs_pipeline"] <= 1e-4:
        raise AssertionError(f"counter vs pipeline: max abs "
                             f"{out['max_abs_vs_pipeline']} > 1e-4")
    state["large_k_seqs"] = large_k_seqs
    state["seqs"] = seqs
    state["long_pair"] = (long_seqs[7], long_seqs[19])  # phase 10's textplot words


def _needed_bytes(lengths, lpad: int, k: int) -> int:
    """Bytes the histogram must move: the digits of every counted window (each
    read once), the lengths, and the float32 output (written once)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    digits = np.where(lengths - (k - 1) > 0, np.minimum(lengths, lpad), 0).sum()
    return int(digits + 4 * lengths.size + 4 * lengths.size * 4 ** k)


def _offset_codes(b, n, k):
    """Row-offset window codes of the valid windows (the input of the
    bincount yardstick), computed once, outside its timing."""
    import torch

    from seekr_tpu_torch.ops.count import window_codes

    code, valid = window_codes(b, n, k)
    code += torch.arange(b.shape[0], device=b.device)[:, None] * (1 << (2 * k))
    return code[valid]


def phase_timing(device, scale, state):
    """Each kernel at its main-path shapes: time, bound, plain and library times.

    count_kmers_smem: the pipeline's one [m, 4096] launch at k = 6.
    count_kmers_hiblocked: the k = 9 counter run's bucket launches, summed.
    Also holds each kernel against count_torch at those shapes (and at the
    k = 6 counter's buckets).  The yardstick ``library_ms`` is one
    ``torch.bincount`` over precomputed row-offset window codes: the raw
    histogram only, without the scale.
    """
    if not is_cuda(device):
        log("kernel timing: skipped on the CPU")
        return
    import torch

    from seekr_tpu_torch.io.encode import encode_seqs
    from seekr_tpu_torch.models.counter import _MAX_ROWS_PER_BUCKET
    from seekr_tpu_torch.ops.count import count_torch
    from seekr_tpu_torch.ops.count_cuda import count_kmers_cuda

    def shapes_of(seqs, k):
        enc = encode_seqs(seqs, k, max_rows_per_bucket=_MAX_ROWS_PER_BUCKET)
        return [(torch.as_tensor(b, device=device), torch.as_tensor(n, device=device))
                for b, n, _ in enc.buckets]

    bases, lengths = state["corpus"]
    work = {
        "count_kmers_smem": (PIPELINE_K, [(torch.as_tensor(bases, device=device),
                                           torch.as_tensor(lengths, device=device))]),
        "count_kmers_hiblocked": (LARGE_K, shapes_of(state["large_k_seqs"], LARGE_K)),
    }
    for b, n in shapes_of(state["seqs"], PIPELINE_K):  # the k = 6 counter's buckets
        got, want = count_kmers_cuda(b, n, PIPELINE_K), count_torch(b, n, PIPELINE_K)
        if not torch.equal(got, want):
            raise AssertionError(f"count_kmers_smem differs at bucket {tuple(b.shape)}")

    rows = []
    for name, (k, inputs) in work.items():
        err = 0.0
        for b, n in inputs:
            got, want = count_kmers_cuda(b, n, k), count_torch(b, n, k)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from count_torch at {tuple(b.shape)}")
            err = max(err, (got - want).abs().max().item())
            del got, want
        record_err(state, name, err)
        ms_by_launch = [cuda_ms(lambda b=b, n=n: count_kmers_cuda(b, n, k), scale.reps)
                        for b, n in inputs]
        ms = sum(ms_by_launch)
        plain_ms = sum(cuda_ms(lambda b=b, n=n: count_torch(b, n, k), scale.reps)
                       for b, n in inputs)
        library_ms = 0.0
        for b, n in inputs:
            codes = _offset_codes(b, n, k)
            minlength = b.shape[0] << (2 * k)
            library_ms += cuda_ms(lambda c=codes: torch.bincount(c, minlength=minlength),
                                  scale.reps)
            del codes
        nbytes = sum(_needed_bytes(n.cpu().numpy(), b.shape[1], k) for b, n in inputs)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"{name}: {nbytes / (ms / 1e3) / 1e9:.1f} GB/s of the bytes it must move, "
            f"{bound_ms / ms:.1%} of its bound; ms by launch {ms_by_launch}")
        if name == "count_kmers_hiblocked":
            hiblocked_detail(inputs, k, scale, device, state)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": state["launches"][name],
            "max_abs_err": state["max_abs_err"][name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms,
        })
        log(f"{name}: k={k}, {len(inputs)} launch(es) of shapes "
            f"{[tuple(b.shape) for b, _ in inputs]}: {ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({nbytes} bytes at 3.35 TB/s), plain {plain_ms:.3f} ms, "
            f"bincount yardstick {library_ms:.3f} ms")
    state["kernels"] = rows + epilogue_timing(device, scale, state) + [
        sym_gemm_timing(device, scale, state)]


def _gap(a, b) -> tuple:
    """Largest distance of two float32 tensors, in ulp and absolute (NaN where
    both are NaN)."""
    import torch

    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        raise AssertionError("the kernel's NaN are not its twin's")
    if not (~nan).any():
        return 0, 0.0
    a, b = a[~nan], b[~nan]
    return (int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max()),
            float((a.double() - b.double()).abs().max()))


def _held(label, name, what, gaps, most_ulp) -> tuple:
    """The largest of ``gaps`` (ulp, absolute); raises past ``most_ulp`` ulp."""
    ulp, err = max(g[0] for g in gaps), max(g[1] for g in gaps)
    if ulp > most_ulp:
        raise AssertionError(f"{name} at {label}: {what} {ulp} float32 ulp from its twin "
                             f"(at most {most_ulp})")
    return ulp, err


def epilogue_timing(device, scale, state) -> list:
    """Each epilogue kernel alone on the forward's operand: the k = 6 count
    buffer [m, 4,096], and the first 4,096-column block of the k = 9 buffer
    [m, 262,144] (its rows 1 MB apart), Log2.post with computed statistics.

    ``library_ms`` is the torch chain's launches the kernel replaces on the same
    block: the column mean, std and min (column statistics); ``sub_``, ``div_``
    and the shifted ``accurate_log2`` (normalize); the row mean and std (row
    statistics); the rows' ``sub``, ``div_`` and ``split_tf32`` (standardize-split).
    Each is held to its twin, else this raises: the column mean and std and
    the rows' mean and std within one float32 ulp of the twin's (float64 sums in
    another order), the shift and every element written bitwise the twin's
    given the kernel's statistics.  ``max_abs_err`` is the largest absolute
    difference from the twin, ``max_ulp`` the same in float32 ulp.  The timing
    loops' launches are not counted.
    """
    import torch

    from seekr_tpu_torch.ops import epilogue_cuda as E
    from seekr_tpu_torch.ops.count import count_graph
    from seekr_tpu_torch.ops.math import accurate_log2
    from seekr_tpu_torch.ops.pearson import split_tf32

    bases, lengths = state["corpus"]
    bt, nt = torch.as_tensor(bases, device=device), torch.as_tensor(lengths, device=device)
    found = {name: {} for name in E.KERNELS}
    for label, k in (("k6", PIPELINE_K), ("k9_block", LARGE_K)):
        raw = count_graph(bt, nt, k)
        m, n = raw.shape
        cols = slice(0, min(n, 4096))
        width = cols.stop
        blk = raw[:, cols]
        bound = {name: b * m * width / HBM_BYTES_PER_S * 1e3
                 for name, b in EPILOGUE_BYTES.items()}

        def stats(engine, x):
            work = engine(x, [cols], None, None, pre=False, post=True)
            work.stats(0, cols)
            return work

        twin_x = blk.clone()
        work, twin = stats(E.Normalize, raw), stats(E.NormalizePlain, twin_x)
        name = "epilogue_column_stats"
        ulp, err = _held(label, name, "mean and std", (_gap(work.mean[cols], twin.mean[cols]),
                                                       _gap(work.std[cols], twin.std[cols])), 1)
        fed = E.NormalizePlain(twin_x, [cols], work.mean[cols], work.std[cols], pre=False,
                               post=True)
        fed.stats(0, cols)
        _held(label, name, "the shift", [_gap(work.running.abs(), fed.running.abs())], 0)
        found[name][label] = {
            "ms": cuda_ms(lambda: stats(E.Normalize, raw), scale.reps),
            "plain_ms": cuda_ms(lambda: stats(E.NormalizePlain, twin_x), scale.reps),
            "library_ms": cuda_ms(lambda: (blk.mean(dim=0), blk.std(dim=0, correction=0),
                                           blk.min()), scale.reps),
            "max_abs_err": err, "max_ulp": ulp}

        work.apply(cols)
        fed.apply(cols)
        sync(device)
        mean, std, shift = work.mean[cols], work.std[cols], work.running[-1].abs()
        err = float((blk - twin_x).abs().nan_to_num().max())
        if not torch.equal(blk.view(torch.int32), twin_x.view(torch.int32)):
            raise AssertionError(f"epilogue_normalize is not its twin at {label}")

        def chain():
            blk.sub_(mean)
            blk.div_(std)
            accurate_log2(blk + shift + 1.0, out=blk)

        # each reapplies the steps to the block it changed: its values stay finite
        found["epilogue_normalize"][label] = {
            "ms": cuda_ms(lambda: work.apply(cols), scale.reps),
            "plain_ms": cuda_ms(lambda: fed.apply(cols), scale.reps),
            "library_ms": cuda_ms(chain, scale.reps), "max_abs_err": err, "max_ulp": 0}
        del twin_x, twin, fed

        moments = E.row_moments(raw, [cols])
        twin_moments = E.row_moments_plain(raw, [cols])
        ulp, err = _held(label, "epilogue_row_stats", "the rows' mean and std",
                         [_gap(a, b) for a, b in zip(E.row_stats(raw, moments),
                                                     E.row_stats(raw, twin_moments))], 1)
        found["epilogue_row_stats"][label] = {
            "ms": cuda_ms(lambda: E.row_moments(raw, [cols]), scale.reps),
            "plain_ms": cuda_ms(lambda: E.row_moments_plain(raw, [cols]), scale.reps),
            "library_ms": cuda_ms(lambda: (blk.mean(dim=1), blk.std(dim=1, correction=0)),
                                  scale.reps),
            "max_abs_err": err, "max_ulp": ulp}

        halves = [torch.empty((m, width), device=device) for _ in range(4)]
        got = E.standardize_split(raw, moments, cols, *halves[:2])
        want = E.standardize_split_plain(raw, moments, cols, *halves[2:])
        sync(device)
        err = max(float((a - b).abs().nan_to_num().max()) for a, b in zip(got, want))
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want)):
            raise AssertionError(f"epilogue_standardize_split is not its twin at {label}")
        row_mean, row_std = (v[:, None] for v in E.row_stats(raw, moments))
        a = torch.empty((m, width), device=device)

        def split_chain():
            torch.sub(blk, row_mean, out=a)
            a.div_(row_std)
            split_tf32(a, *halves[2:])

        found["epilogue_standardize_split"][label] = {
            "ms": cuda_ms(lambda: E.standardize_split(raw, moments, cols, *halves[:2]),
                          scale.reps),
            "plain_ms": cuda_ms(lambda: E.standardize_split_plain(raw, moments, cols,
                                                                  *halves[2:]), scale.reps),
            "library_ms": cuda_ms(split_chain, scale.reps), "max_abs_err": err, "max_ulp": 0}
        for name in E.KERNELS:
            found[name][label]["bound_ms"] = bound[name]
        del raw, blk, work, halves, a, got, want
        torch.cuda.empty_cache()
    E.reset_launches()

    rows = []
    for name in E.KERNELS:
        k6 = found[name]["k6"]
        rows.append({
            "name": name, "route": "cuda", "source": EPILOGUE_SOURCE,
            "replaces": EPILOGUE_REPLACES,
            "launches": state.get("epilogue_launches", {}).get(name, 0),
            "max_abs_err": max(v["max_abs_err"] for v in found[name].values()),
            "max_ulp": max(v["max_ulp"] for v in found[name].values()),
            "ms": k6["ms"], "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
            "bound_by": "bytes", "library_ms": k6["library_ms"],
            "k9_block": found[name]["k9_block"]})
        log(f"{name}: k = 6 {k6['ms']:.4f} ms, bound {k6['bound_ms']:.4f} ms "
            f"({k6['bound_ms'] / k6['ms']:.1%}), plain {k6['plain_ms']:.3f} ms, torch chain "
            f"{k6['library_ms']:.3f} ms; k = 9 block {json.dumps(found[name]['k9_block'])}")
    return rows


def cublas_composition(hi, lo, n, out=None, x=None):
    """The cuBLAS products the symmetric GEMM replaced.  A whole Gram (``out``
    None): ``X = hi lo^T``, ``X + X^T``, eight 512-column ``addmm_`` of
    ``hi hi^T``, the divide.  One middle block of many: ``x.addmm_(hi, lo^T)``
    and the eight ``out.addmm_``."""
    from seekr_tpu_torch.ops.pearson import divide
    from seekr_tpu_torch.ops.precision import pearson_precision

    whole = out is None
    with pearson_precision(tf32=True):
        if whole:
            x = hi @ lo.T
            out = x + x.T
        else:
            x.addmm_(hi, lo.T)
        for c in range(0, hi.shape[1], 512):
            out.addmm_(hi[:, c:c + 512], hi[:, c:c + 512].T)
    return divide(out, n) if whole else out


def sym_gemm_timing(device, scale, state) -> dict:
    """The symmetric GEMM alone on the forward's operand: the k = 6 forward's
    [m, 4,096] (one block, first and last) and the first 4,096-column block of
    the k = 9 buffer as a middle block (r read and written, nothing divided).

    ``bound_ms``: its three TF32 products over the upper triangle with its
    diagonal (3 * 2 * w * m (m + 1) / 2 operations) at the TF32 peak;
    ``plain_ms`` its twin (float32 products over the whole square);
    ``library_ms`` the cuBLAS composition it replaced (``cublas_composition``).
    Raises unless r is exactly symmetric, NaN where float64 is, and within 1e-5
    of float64 of the halves' Gram (``max_abs_err``); the k = 9 block is checked
    a second time as the last block, added into the middle block's r and divided
    by twice its width.  The timing loops' calls are not counted.
    """
    import torch

    from seekr_tpu_torch.models.pipeline import SeekrPipeline
    from seekr_tpu_torch.ops import pearson as P
    from seekr_tpu_torch.ops import sym_gemm_cuda as S

    bases, lengths = state["corpus"]
    bt, nt = torch.as_tensor(bases, device=device), torch.as_tensor(lengths, device=device)
    found = {}
    for label, k in (("k6", PIPELINE_K), ("k9_block", LARGE_K)):
        counts = SeekrPipeline(k=k, log2="Log2.post", device=device).counts(bt, nt)[0]
        a = P._row_standardize(counts[:, :4096].contiguous())
        del counts
        m, w = a.shape
        first_last = label == "k6"
        hi, lo = P.split_tf32(a)
        r = torch.zeros((m, m), device=device)
        twin = torch.zeros((m, m), device=device)

        def kernel():
            return S.sym_split_gemm(hi, lo, r, first_last, first_last, w)

        def plain():
            return S.sym_split_gemm_plain(hi, lo, twin, first_last, first_last, w)

        kernel()
        a64 = hi.double() + lo.double()
        want = (a64 @ a64.T) / w
        del a64
        got = r.double() if first_last else r.double() / w  # a middle block divides nothing
        sync(device)
        bits = r.view(torch.int32)
        if first_last and not torch.equal(bits, bits.T):
            raise AssertionError(f"{SYM_GEMM} at {label}: r is not exactly symmetric")
        # before the last block only the upper triangle is r's
        check = torch.ones((m, m), dtype=torch.bool, device=device)
        if not first_last:
            check.triu_()
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got)[check], nan[check]):
            raise AssertionError(f"{SYM_GEMM} at {label}: NaN where float64 has none, or none "
                                 f"where it has")
        err = float((got - want)[check & ~nan].abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"{SYM_GEMM} at {label}: {err} from float64")
        last = {}
        if not first_last:
            # the same block again as the last of two, adding into r: r = 2 G / 2 w
            S.sym_split_gemm(hi, lo, r, False, True, 2 * w)
            sync(device)
            bits = r.view(torch.int32)
            last_err = float((r.double() - want)[~nan].abs().max())
            if not (torch.equal(bits, bits.T) and torch.equal(torch.isnan(r), nan)
                    and last_err <= 1e-5):
                raise AssertionError(f"{SYM_GEMM} at {label} as the last block: symmetric "
                                     f"{torch.equal(bits, bits.T)}, {last_err} from float64")
            last["last_block_max_abs_err"] = last_err
        del want, got, nan, check
        if first_last:
            library = lambda: cublas_composition(hi, lo, w)  # noqa: E731
        else:
            out, x = torch.zeros((m, m), device=device), torch.zeros((m, m), device=device)
            library = lambda: cublas_composition(hi, lo, w, out, x)  # noqa: E731
        found[label] = {
            "ms": cuda_ms(kernel, scale.reps), "plain_ms": cuda_ms(plain, scale.reps),
            "library_ms": cuda_ms(library, scale.reps),
            "bound_ms": 3 * 2 * w * (m * (m + 1) // 2) / TF32_FLOPS_PER_S * 1e3,
            "max_abs_err": err, **last}
        del a, hi, lo, r, twin
        if not first_last:
            del out, x
        torch.cuda.empty_cache()
    reset_sym_gemm()
    k6 = found["k6"]
    log(f"{SYM_GEMM}: k = 6 {k6['ms']:.4f} ms, bound {k6['bound_ms']:.4f} ms "
        f"({k6['bound_ms'] / k6['ms']:.1%}), plain {k6['plain_ms']:.3f} ms, cuBLAS composition "
        f"{k6['library_ms']:.3f} ms; k = 9 block {json.dumps(found['k9_block'])}")
    return {"name": SYM_GEMM, "route": "cuda", "source": SYM_GEMM_SOURCE,
            "replaces": SYM_GEMM_REPLACES, "launches": state.get(SYM_GEMM, 0),
            "max_abs_err": k6["max_abs_err"], "ms": k6["ms"], "plain_ms": k6["plain_ms"],
            "bound_ms": k6["bound_ms"], "bound_by": "operations",
            "library_ms": k6["library_ms"], "k9_block": found["k9_block"]}


def hiblocked_detail(inputs, k, scale, device, state):
    """Where count_kmers_hiblocked's time goes: against a write-only pass over
    the same output (``zero_``), and its time against its bound at phase 2's
    widest cases."""
    import torch

    from seekr_tpu_torch.ops.count_cuda import count_kmers_cuda

    outs = [torch.empty((b.shape[0], 1 << (2 * k)), device=device) for b, _ in inputs]
    out = {"phase": "timing", "kernel": "count_kmers_hiblocked", "k": k,
           "write_only_ms": sum(cuda_ms(o.zero_, scale.reps) for o in outs)}
    del outs
    rng = np.random.default_rng(state["seed"] + 3)
    for wide_k, m in WIDE_K_CASES:
        b, n = kernel_case(rng, m, scale.kernel_lmax, wide_k)
        bt, nt = torch.as_tensor(b, device=device), torch.as_tensor(n, device=device)
        out[f"k{wide_k}_m{m}_ms"] = cuda_ms(
            lambda b=bt, n=nt, k=wide_k: count_kmers_cuda(b, n, k), scale.reps)
        out[f"k{wide_k}_m{m}_bound_ms"] = (_needed_bytes(n, b.shape[1], wide_k)
                                           / HBM_BYTES_PER_S * 1e3)
    log(json.dumps(out))


STATS_K = 4
PVAL_CELL_QUERIES = 500  # the query rows of the benchmark's pval cell
STATS_MODELS = ["norm", "expon", "rayleigh", "uniform"]
CLI_FIT_MODELS = ["expon", "norm"]


def f64_pearson(c1, c2):
    """Row-standardize + Gram / n in float64 on the host."""
    def standardize(c):
        c = np.asarray(c, dtype=np.float64)
        c = c - c.mean(axis=1, keepdims=True)
        return c / c.std(axis=1, keepdims=True)

    return standardize(c1) @ standardize(c2).T / c1.shape[1]


def direct_bh(p):
    """Benjamini-Hochberg in float64 numpy, written out: p * n / rank, the
    running minimum from the largest rank down, clipped to 1."""
    p = np.asarray(p, dtype=np.float64).ravel()
    order = np.argsort(p, kind="stable")
    ranked = p[order] * len(p) / np.arange(1, len(p) + 1)
    ranked = np.minimum(np.minimum.accumulate(ranked[::-1])[::-1], 1.0)
    out = np.empty_like(ranked)
    out[order] = ranked
    return out


def near_background(r, background, tol=1e-5, count=False):
    """Cells of ``r`` within ``tol`` of some background value (or, with
    ``count``, how many background values lie that near each cell)."""
    b = np.sort(np.asarray(background, dtype=np.float64))
    n = np.searchsorted(b, r + tol, side="right") - np.searchsorted(b, r - tol, side="left")
    return n if count else n > 0


def host_paths_agree(device, scale, seqs, p_emp) -> dict:
    """Each host path the C++ library took over against the Python/numpy path it
    replaced, at the main path's sizes (in phase 6's working directory): the
    counts, the corrections and the p-value CSV's bytes equal; BH on the card
    the same bytes as both, ``fdr_routes["device"]`` showing it ran there; and
    the pval cell's ECDF on the device bitwise the host's."""
    import torch

    from seekr_tpu_torch.io.fast_csv import labeled_csv_bytes, write_labeled_csv
    from seekr_tpu_torch.models.counter import KmerCounter
    from seekr_tpu_torch.models.pearson import pearson
    from seekr_tpu_torch.ops.ecdf import DeviceSortedBackground, SortedBackground
    from seekr_tpu_torch.stats import adj_pval
    from seekr_tpu_torch.stats.find_dist import similarity_triu
    from seekr_tpu_torch.stats.multitest import _NATIVE_SORT_MIN, fdr_routes, multipletests

    counts = KmerCounter("corpus.fa", k=STATS_K, silent=True, device=device).get_counts_device()
    with python_host_paths():
        python_counts = KmerCounter("corpus.fa", k=STATS_K, silent=True,
                                    device=device).get_counts_device()
    if not torch.equal(counts, python_counts):
        raise AssertionError("phase 6 counts: the native parse and encode differ")
    del python_counts
    # the pval cell's ECDF at its sizes, every pair's r as the null against
    # 500 query rows: on the host, and on the device (find_pval's path on a
    # card), bitwise equal
    triu = similarity_triu(counts, device=device)
    cell_r = pearson(counts[:scale.stats_query], counts, device=device)[:PVAL_CELL_QUERIES]
    host_p = SortedBackground(triu).pvals(cell_r).astype(np.float32)
    device_p = DeviceSortedBackground(triu, device).pvals(torch.as_tensor(cell_r, device=device))
    out = {"ecdf_cell_cells": int(cell_r.size), "ecdf_cell_null_values": len(triu),
           "ecdf_cell_device_bitwise_host": device_p.tobytes() == host_p.tobytes()}
    if not out["ecdf_cell_device_bitwise_host"]:
        raise AssertionError("the device ECDF differs from the host's at the pval cell's sizes")
    del triu, host_p, device_p
    # BH on the card (the default where there is one, past the host sort's
    # threshold), in the C++ library and in numpy: the same bytes
    routes = dict(fdr_routes)
    device_mt = multipletests(p_emp.values, method="fdr_bh")
    device_adj = adj_pval(p_emp, "fdr_bh").values
    on_card = torch.device(device).type == "cuda" and p_emp.values.size >= _NATIVE_SORT_MIN
    if fdr_routes["device"] != routes["device"] + 2 * on_card:
        raise AssertionError(f"phase 6 BH: the card's route was {'not ' * on_card}taken: "
                             f"{routes} -> {fdr_routes}")
    native_mt = multipletests(p_emp.values, method="fdr_bh", device="cpu")
    native_adj = adj_pval(p_emp, "fdr_bh", device="cpu").values
    with python_host_paths():
        numpy_mt = multipletests(p_emp.values, method="fdr_bh", device="cpu")
        numpy_adj = adj_pval(p_emp, "fdr_bh", device="cpu").values
    out["fdr_routes"] = dict(fdr_routes)
    same = {"multipletests_bitwise_numpy": all(
                a.tobytes() == b.tobytes() for a, b in zip(native_mt[:2], numpy_mt[:2])),
            "adj_pval_bitwise_numpy": native_adj.tobytes() == numpy_adj.tobytes(),
            "multipletests_device_bitwise_numpy": all(
                a.tobytes() == b.tobytes() for a, b in zip(device_mt[:2], numpy_mt[:2])),
            "adj_pval_device_bitwise_numpy": device_adj.tobytes() == numpy_adj.tobytes()}
    write_labeled_csv("pvals.csv", p_emp.values, p_emp.index, p_emp.columns)
    same["pvals_csv_bytes_equal_python"] = (Path("pvals.csv").read_bytes() == labeled_csv_bytes(
        p_emp.values, p_emp.index, p_emp.columns))
    out.update(same)
    failed = [name for name, ok in same.items() if not ok]
    if failed:
        raise AssertionError(f"native host paths differ from the Python ones: {failed}")
    return out


def phase_stats(device, scale, state):
    """The statistics chain at k = 4: find_dist -> fit -> find_pval (three
    calls) -> adj_pval, pearson_pairs, and the six CLI commands in process."""
    import os

    import scipy.stats

    from seekr_tpu_torch import cli
    from seekr_tpu_torch.io.fast_csv import read_labeled_csv
    from seekr_tpu_torch.models.counter import KmerCounter
    from seekr_tpu_torch.models.pearson import pearson
    from seekr_tpu_torch.ops import count_cuda
    from seekr_tpu_torch.ops.ecdf import SortedBackground
    from seekr_tpu_torch.ops.pearson import pearson_blocked, pearson_pairs
    from seekr_tpu_torch.stats import adj_pval, find_dist, find_pval
    from seekr_tpu_torch.stats.adj_pval import is_symmetric
    from seekr_tpu_torch.stats.find_dist import fit_distributions, resolve_models

    seqs = state["seqs"]
    m, q, s = len(seqs), scale.stats_query, scale.stats_self
    dev = str(device)

    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            write_fasta_file("corpus.fa", seqs)  # set-up: the files the user would have
            write_fasta_file("query.fa", seqs[:q])
            write_fasta_file("self.fa", seqs[:s])
            vectors = (f"bkg_mean_{STATS_K}mers.npy", f"bkg_std_{STATS_K}mers.npy")

            reset_launches()
            np.random.seed(state["seed"])
            bkg = find_dist("corpus.fa", k_mer=STATS_K, subsetting=True,
                            subset_size=scale.stats_subset, fit_model=False, device=device)
            state["stats_background"] = bkg  # phase 11 draws it again on the mesh
            fitres = fit_distributions(bkg, resolve_models(STATS_MODELS))
            pvals = {
                "empirical": find_pval("query.fa", "corpus.fa", *vectors, STATS_K, bkg,
                                       device=device),
                "fitted": find_pval("query.fa", "corpus.fa", *vectors, STATS_K, fitres,
                                    device=device),
                "self": find_pval("self.fa", "self.fa", *vectors, STATS_K, fitres,
                                  device=device)}
            adjusted = {name: adj_pval(pv, "fdr_bh") for name, pv in pvals.items()}
            counts = KmerCounter("corpus.fa", mean=vectors[0], std=vectors[1], k=STATS_K,
                                 silent=True, device=device).get_counts_device()
            rng = np.random.default_rng(state["seed"] + 4)
            ii, jj = rng.integers(0, m, size=(2, scale.stats_pairs))
            pairs = pearson_pairs(counts, ii, jj, device=device)
            # the CLI's find_dist rewrites the k = 4 vectors from query.fa, and
            # its find_pval then uses them
            cli_runs = [
                ["kmer_counts", "query.fa", "-o", "counts.csv"],
                ["norm_vectors", "query.fa", "-mv", "q_mean.npy", "-sv", "q_std.npy"],
                ["pearson", "counts.csv", "counts.csv", "-o", "pearson.csv"],
                ["find_dist", "query.fa", "-k", "4", "-sbt", "-sbs",
                 str(min(scale.stats_subset, q * (q - 1) // 4)), "-o", "cli_bkg"],
                ["find_dist", "query.fa", "-k", "4", "-fm", "-mdl", ",".join(CLI_FIT_MODELS),
                 "-sbt", "-sbs", str(min(scale.stats_subset, q * (q - 1) // 4)),
                 "-o", "cli_fit"],
                ["find_pval", "query.fa", "query.fa", *vectors, "4", "cli_fit.csv",
                 "-o", "cli_pvals"],
                ["adj_pval", "cli_pvals.csv", "fdr_bh", "-o", "cli_adj"],
            ]
            for argv in cli_runs:
                cli.main(argv + ["--device", dev])
            read_launches(state, "stats")
            if is_cuda(device) and count_cuda.launches["count_kmers_smem"] == 0:
                raise AssertionError("the statistics chain never launched count_kmers_smem")

            # -- checks --------------------------------------------------------
            out = {"phase": "stats", "m": m, "k": STATS_K, "background_values": len(bkg)}
            if bkg.shape != (min(scale.stats_subset, m * (m - 1) // 2),) \
                    or not np.isfinite(bkg).all():
                raise AssertionError(f"find_dist: shape {bkg.shape}")
            c_query = counts[:q]
            r_port = pearson(c_query, counts, device=device)
            r64 = f64_pearson(c_query.cpu().numpy(), counts.cpu().numpy())
            out["r_max_abs_vs_f64"] = float(np.abs(r_port - r64).max())
            if not out["r_max_abs_vs_f64"] <= 1e-4:
                raise AssertionError(f"r vs float64: {out['r_max_abs_vs_f64']} > 1e-4")

            p_emp = pvals["empirical"]
            if p_emp.shape != (q, m) or p_emp.index != [f"t{i}" for i in range(q)]:
                raise AssertionError(f"find_pval: shape {p_emp.shape}")
            near = near_background(r64, bkg)
            out["empirical_near_tie_share"] = float(near.mean())
            want = SortedBackground(bkg).pvals(r64)
            bad = int((p_emp.values != want.astype(np.float32))[~near].sum())
            if bad:
                raise AssertionError(f"empirical p-values differ in {bad} cells away from ties")
            # in every cell: the exceedance counts differ by at most the
            # background values within 1e-5 of r
            n_near = near_background(r64, bkg, count=True)
            diff = np.abs(np.rint(p_emp.values.astype(np.float64) * len(bkg))
                          - np.rint(want * len(bkg)))
            out["empirical_max_count_diff"] = float(diff.max())
            if (diff > n_near).any():
                raise AssertionError("empirical exceedance counts differ by more than "
                                     "the background values near r")
            # and against a plain count, independent of SortedBackground, on
            # random cells: the share of background values greater than r
            cells = np.random.default_rng(state["seed"] + 6).choice(
                r64.size, size=min(scale.stats_plain_cells, r64.size), replace=False)
            bkg64, r_cells = np.asarray(bkg, dtype=np.float64), r64.ravel()[cells]
            plain_count = np.concatenate([
                np.count_nonzero(bkg64[None, :] > r_cells[i:i + 256, None], axis=1)
                for i in range(0, len(cells), 256)])
            plain = (plain_count / len(bkg64)).astype(np.float32)
            got = p_emp.values.ravel()[cells]
            near_cells = near.ravel()[cells]
            bad = int((got != plain)[~near_cells].sum())
            count_diff = np.abs(np.rint(got.astype(np.float64) * len(bkg64)) - plain_count)
            out["empirical_plain_cells"] = len(cells)
            out["empirical_plain_max_count_diff"] = float(count_diff.max())
            if bad or (count_diff > n_near.ravel()[cells]).any():
                raise AssertionError(f"empirical p-values vs a plain count: {bad} cells "
                                     "differ away from ties, or a count differs by more "
                                     "than the background values near r")

            # a model that fails to fit is only printed and skipped: every one
            # asked for must come back, from the API and from the CLI's -fm run
            fitted = {"api": sorted(row[0] for row in fitres),
                      "cli": sorted(row[0] for row in
                                    cli.parse_fitres_csv("cli_fit.csv", "distribution"))}
            out["fitted_models"] = fitted
            if fitted["api"] != sorted(STATS_MODELS) or fitted["cli"] != CLI_FIT_MODELS:
                raise AssertionError(f"models missing from the fits: {fitted}")

            name, _, params = fitres[0]
            out["best_fit"] = name
            want = 1.0 - getattr(scipy.stats, name)(*params).cdf(r64)
            out["fitted_max_abs_vs_scipy"] = float(np.abs(pvals["fitted"].values
                                                          - want).max())
            if not out["fitted_max_abs_vs_scipy"] <= 1e-4:
                raise AssertionError(f"fitted p-values: {out['fitted_max_abs_vs_scipy']}")

            p_self = pvals["self"]
            if not np.array_equal(p_self.values, p_self.values.T) or not is_symmetric(p_self):
                raise AssertionError("the self p-value matrix is not exactly symmetric")

            worst = 0.0
            for name in ("empirical", "fitted", "self"):
                pv, adj = pvals[name], adjusted[name]
                if name == "self":
                    iu = np.triu_indices(s, 1)
                    got, want = adj.values[iu], direct_bh(pv.values[iu])
                    if not np.isnan(adj.values[np.tril_indices(s)]).all():
                        raise AssertionError("adj_pval on the self matrix left the lower "
                                             "triangle: not the upper-triangle path")
                else:
                    got, want = adj.values.ravel(), direct_bh(pv.values)
                worst = max(worst, float(np.abs(got - want).max()))
            out["adj_max_abs_vs_direct_bh"] = worst
            if not worst <= 1e-12:
                raise AssertionError(f"adj_pval vs direct BH: {worst} > 1e-12")

            full = pearson_blocked(counts, counts, device=device)
            out["pairs_max_abs_vs_blocked"] = float(np.abs(pairs - full[ii, jj]).max())
            del full
            if not out["pairs_max_abs_vs_blocked"] <= 1e-5:
                raise AssertionError(f"pearson_pairs: {out['pairs_max_abs_vs_blocked']}")

            cli_adj = read_labeled_csv("cli_adj.csv")
            if cli_adj.shape != (q, q) or not np.isnan(cli_adj.values[np.tril_indices(q)]).all():
                raise AssertionError(f"CLI adj_pval: shape {cli_adj.shape}")
            if read_labeled_csv("pearson.csv").shape != (q, q) \
                    or read_labeled_csv("counts.csv").shape != (q, 4 ** PIPELINE_K):
                raise AssertionError("CLI kmer_counts / pearson artifacts")

            out.update(host_paths_agree(device, scale, seqs, p_emp))
        finally:
            os.chdir(home)

    log(json.dumps(out))
    state["stats"] = out


SERVE_K = 6
SERVE_TOPK = 10
SERVE_QUANTUM = 256
SERVE_LEN = (512, 2048)  # query lengths, uniform (bench.py's L_MIN, L_MAX)
SERVE_CHECK_Q = 4        # rows of the queries that check growth, snapshots, the socket


def random_queries(rng, n):
    return [DIGIT2CHAR[rng.integers(0, 4, size=int(rng.integers(*SERVE_LEN)))].tobytes().decode()
            for _ in range(n)]


def coalesced_burst(svc, batches_by_thread):
    """Every thread sends its batches through ``svc.query`` back to back, all
    threads released together.  Returns the answers by thread, in order."""
    import threading

    barrier = threading.Barrier(len(batches_by_thread))
    answers = [None] * len(batches_by_thread)
    errors = []

    def client(i):
        try:
            barrier.wait(timeout=60)
            answers[i] = [svc.query(b, want=("topk",), topk=SERVE_TOPK)
                          for b in batches_by_thread[i]]
        except Exception as err:  # noqa: BLE001 -- raised below
            errors.append(err)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(answers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"coalesced burst: errors {errors[:3]}, "
                             f"{sum(t.is_alive() for t in threads)} threads still running")
    return answers


def socket_round_trip(svc, queries):
    """ping, one topk_pvals query and shutdown through ``serve_forever`` on a
    UNIX socket in the working directory; the server thread is joined."""
    import threading

    from seekr_tpu_torch.serve import request, serve_forever

    path = "serve.sock"  # relative: short whatever the temporary directory is
    ready = threading.Event()
    server = threading.Thread(target=serve_forever, args=(svc, path, ready), daemon=True)
    server.start()
    try:
        if not ready.wait(60):
            raise AssertionError("the socket server never came up")
        pong = request(path, {"op": "ping"}, timeout=60)
        answer = request(path, {"seqs": queries, "want": ["topk_pvals"],
                                "topk": SERVE_TOPK}, timeout=60)
    finally:
        try:
            request(path, {"op": "shutdown"}, timeout=60)
        except OSError:
            pass
        server.join(timeout=60)
    if server.is_alive():
        raise AssertionError("the socket server did not stop")
    return pong, answer


def topk_agrees(got_vals, got_idx, ref_vals, ref_idx, tol=1e-6):
    """Coalesced top-k against the serial one: values within ``tol``, and
    indices equal wherever a value is more than ``tol`` from its neighbours
    (``ref_*`` carry one column more, the (k+1)-th)."""
    k = got_idx.shape[1]
    if not np.abs(got_vals - ref_vals[:, :k]).max() <= tol:
        return False
    gaps = np.abs(np.diff(ref_vals, axis=1)) > tol  # [q, k] gaps to the next value
    firm = gaps.copy()
    firm[:, 1:] &= gaps[:, :-1]
    return bool(np.array_equal(got_idx[firm], ref_idx[:, :k][firm]))


def phase_serve(device, scale, state):
    """The warm-resident service at the JAX benchmark's serving size
    (``bench.py:410-475``): the corpus as targets at k = 6, Log2.post, an
    empirical background from find_dist, Q=1 sim and Q=128 top-k queries, a
    coalesced burst, growth, a snapshot and the socket."""
    import os

    from seekr_tpu_torch.models.counter import KmerCounter
    from seekr_tpu_torch.ops import count_cuda
    from seekr_tpu_torch.ops.ecdf import SortedBackground
    from seekr_tpu_torch.ops.normalize import normalize_counts_segmented
    from seekr_tpu_torch.serve import SeekrService
    from seekr_tpu_torch.stats import find_dist

    seqs = state["seqs"]
    m = len(seqs)
    rng = np.random.default_rng(state["seed"] + 7)
    rounds = scale.serve_rounds
    q1_batches = [random_queries(rng, 1) for _ in range(rounds * scale.serve_q1 + 1)]
    big_batches = [random_queries(rng, scale.serve_big_q)
                   for _ in range(rounds * scale.serve_big + 1)]
    n_threads, each = scale.serve_burst
    burst = [[random_queries(rng, 1) for _ in range(each)] for _ in range(n_threads)]
    check_q = random_queries(rng, SERVE_CHECK_Q)
    grow_in, grow_across = (random_queries(rng, n) for n in scale.serve_grow)
    out = {"phase": "serve", "card": state.get("smi"), "targets": m, "k": SERVE_K,
           "grow_quantum": SERVE_QUANTUM}

    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # set-up: the files a user would have.  find_dist writes the
            # corpus' column statistics as the norm vectors, as norm_vectors
            # does, and samples the empirical background
            write_fasta_file("targets.fa", seqs)
            np.random.seed(state["seed"])
            bkg = find_dist("targets.fa", k_mer=SERVE_K, subset_size=scale.stats_subset,
                            fit_model=False, exact_subsample_max_pool=0, device=device)
            vectors = (f"bkg_mean_{SERVE_K}mers.npy", f"bkg_std_{SERVE_K}mers.npy")

            # -- the main path: load, warm up, traffic ----------------------
            reset_launches()
            svc = SeekrService(*vectors, k=SERVE_K, targets="targets.fa", fitres=bkg,
                               grow_quantum=SERVE_QUANTUM, device=device)
            out["resident_rows"] = int(svc._targets_std.shape[0])
            svc.warmup()
            out["max_coalesce_rows"] = svc.max_coalesce_rows
            for batch in q1_batches:
                svc.query(batch, want=("sim",))
            for batch in big_batches:
                svc.query(batch, want=("topk",), topk=SERVE_TOPK)
            mixed = svc.query(big_batches[0], want=("sim", "pvals", "topk", "topk_pvals"),
                              topk=SERVE_TOPK)
            batches_before = svc.device_batches
            burst_answers = coalesced_burst(svc, burst)
            out["burst"] = {"threads": n_threads, "queries_each": each,
                            "requests": n_threads * each,
                            "device_batches": svc.device_batches - batches_before,
                            "answered": sum(len(answers) for answers in burst_answers)}
            read_launches(state, "serve: load, warmup, traffic, burst")
            launched = count_cuda.launches["count_kmers_smem"]

            # the serial answers of the burst (a comparison: not counted)
            svc.coalesce = False
            serial = [[svc.query(b, want=("topk",), topk=SERVE_TOPK + 1) for b in batches]
                      for batches in burst]
            svc.coalesce = True

            # -- the main path: growth, snapshot, socket --------------------
            reset_launches()
            before = svc.query(check_q)["sim"]
            resident = svc._targets_std
            svc.add_targets(grow_in)
            in_place = svc._targets_std is resident
            after = svc.query(check_q)["sim"]
            svc.add_targets(grow_across)
            out["resident_rows_after_growth"] = int(svc._targets_std.shape[0])
            grown = svc.query(check_q)["sim"]
            svc.save_corpus("corpus.npz")
            loaded = SeekrService(*vectors, k=SERVE_K, targets="corpus.npz", fitres=bkg,
                                  grow_quantum=SERVE_QUANTUM, device=device)
            from_snapshot = loaded.query(check_q)["sim"]
            del loaded
            pong, answer = socket_round_trip(svc, check_q)
            in_process = svc.query(check_q, want=("topk_pvals",), topk=SERVE_TOPK)
            read_launches(state, "serve: growth, snapshot, socket")
            launched += count_cuda.launches["count_kmers_smem"]
            if is_cuda(device) and not launched:
                raise AssertionError("the service never launched count_kmers_smem")

            # -- checks -----------------------------------------------------
            q = scale.serve_big_q
            raw_q = svc._count(svc._pad_batch(big_batches[0]))[:q]
            targets = KmerCounter("targets.fa", k=SERVE_K, mean=vectors[0], std=vectors[1],
                                  silent=True, device=device).get_counts_device()
            ref = f64_pearson_device(raw_q, targets)
            out["sim_max_abs_vs_f64"] = float(np.abs(mixed["sim"] - ref).max())
            order = np.argsort(-mixed["sim"], axis=1, kind="stable")[:, :SERVE_TOPK]
            out["topk_equals_stable_sort"] = bool(
                np.array_equal(mixed["topk_idx"], order)
                and np.array_equal(mixed["topk_sim"], np.take_along_axis(mixed["sim"], order, 1)))
            sorted_bkg = SortedBackground(bkg)
            out["empirical_pvals_equal"] = bool(
                np.array_equal(mixed["pvals"], sorted_bkg.pvals(mixed["sim"]).astype(np.float32))
                and np.array_equal(mixed["topk_pvals"],
                                   sorted_bkg.pvals(mixed["topk_sim"]).astype(np.float32)))
            out["segmented_bitwise"] = segmented_bitwise(svc, rng, normalize_counts_segmented)
            out["coalesced_max_abs_vs_serial"] = max(
                float(np.abs(a["topk_sim"] - s["topk_sim"][:, :SERVE_TOPK]).max())
                for answers, refs in zip(burst_answers, serial) for a, s in zip(answers, refs))
            out["coalesced_agrees"] = all(
                topk_agrees(a["topk_sim"], a["topk_idx"], s["topk_sim"], s["topk_idx"])
                for answers, refs in zip(burst_answers, serial) for a, s in zip(answers, refs))
            out["grow_within_in_place"] = in_place
            out["grow_within_bitwise"] = bool(np.array_equal(after[:, :m], before))
            out["grow_across_max_abs"] = float(np.abs(grown[:, :m] - before).max())
            out["snapshot_bitwise"] = bool(np.array_equal(from_snapshot, grown))
            out["socket_equals_in_process"] = bool(
                pong["ok"] and answer["ok"]
                and all(np.array_equal(np.asarray(answer[key]), in_process[key])
                        for key in ("topk_sim", "topk_idx", "topk_pvals")))
        finally:
            os.chdir(home)

    log(json.dumps(out))
    state["serve"] = out
    n_grown = m + sum(scale.serve_grow)
    failures = [name for name, ok in (
        ("sim vs float64", out["sim_max_abs_vs_f64"] <= 1e-4),
        ("top-k vs a stable sort of sim", out["topk_equals_stable_sort"]),
        ("empirical p-values vs SortedBackground", out["empirical_pvals_equal"]),
        ("segmented normalize vs per request", out["segmented_bitwise"]),
        ("coalesced vs serial", out["coalesced_agrees"]),
        ("grow within the quantum: in place", out["grow_within_in_place"]),
        ("grow within the quantum: bitwise", out["grow_within_bitwise"]),
        ("grow across the quantum", out["grow_across_max_abs"] <= 1e-5
         and out["resident_rows_after_growth"] == -(-n_grown // SERVE_QUANTUM) * SERVE_QUANTUM),
        ("snapshot reload bitwise", out["snapshot_bitwise"]),
        ("socket vs in process", out["socket_equals_in_process"]),
        ("burst answered", out["burst"]["answered"] == n_threads * each),
    ) if not ok]
    if failures:
        raise AssertionError(f"serve checks failed: {failures}")


def f64_pearson_device(c1, c2):
    """Row-standardize + Gram / n of two normalized count matrices in float64
    on their device, returned on the host."""
    import torch

    def standardize(c):
        c = c.to(torch.float64)
        c = c - c.mean(dim=1, keepdim=True)
        return c / c.std(dim=1, keepdim=True, correction=0)

    return ((standardize(c1) @ standardize(c2).T) / c1.shape[1]).cpu().numpy()


def segmented_bitwise(svc, rng, normalize_counts_segmented) -> bool:
    """Requests of 1, 3, 2, 5 and 1 rows, counted together and normalized per
    segment, against ``normalize_counts`` of each request alone (the serial
    path's own counts): equal bit for bit."""
    import torch

    requests = [random_queries(rng, n) for n in (1, 3, 2, 5, 1)]
    rows = [s for r in requests for s in r]
    padded = svc._pad_batch(rows)
    seg_ids = np.repeat(np.arange(len(requests), dtype=np.int32), [len(r) for r in requests])
    seg_ids = np.concatenate([seg_ids, np.full(len(padded) - len(rows), len(requests) - 1,
                                               np.int32)])
    merged = normalize_counts_segmented(svc._count_raw(padded), seg_ids, 8, log2_mode=svc.log2,
                                        mean=svc._mean_t, std=svc._std_t)
    start = 0
    for r in requests:
        alone = svc._count(svc._pad_batch(r))[:len(r)]
        if not torch.equal(merged[start:start + len(r)], alone):
            return False
        start += len(r)
    return True


LEIDEN_CUTOFF = 0.2     # -pco of the run: the reference's graphs use such cutoffs
LEIDEN_MUTATION = 0.10  # share of a member's bases that differ from its founder
LEIDEN_QUANTILES = (0.0, 0.001, 0.01, 0.5, 0.99, 0.999, 1.0)


def family_corpus(families: int, members: int, cap: int, seed: int):
    """Planted families of transcripts: (sequences, family of each).

    Each founder's length follows phase 3's law (lognormal, median 1.4 kb,
    200..``cap``) and its bases are uniform; each member is its founder with
    ``LEIDEN_MUTATION`` of its bases, drawn at random, replaced by one of the
    three other bases."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(np.log(1400.0), 0.6, size=families), 200, cap)
    seqs = []
    for n in lengths.astype(int):
        block = np.repeat(rng.integers(0, 4, size=(1, n), dtype=np.int8), members, axis=0)
        hit = rng.random(block.shape) < LEIDEN_MUTATION
        block[hit] = (block[hit] + rng.integers(1, 4, size=int(hit.sum()), dtype=np.int8)) % 4
        seqs += [DIGIT2CHAR[row].tobytes().decode() for row in block]
    return seqs, np.repeat(np.arange(families), members)


def same_partition(a, b) -> bool:
    """Two memberships are one partition up to relabeling: their label pairs
    form a bijection."""
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


def adjusted_rand_index(a, b) -> float:
    """Hubert and Arabie's adjusted Rand index of two memberships."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), dtype=np.int64)
    np.add.at(table, (ai, bi), 1)

    def pairs(x):
        return (x * (x - 1) / 2).sum()

    both, rows, cols = pairs(table), pairs(table.sum(axis=1)), pairs(table.sum(axis=0))
    expected = rows * cols / pairs(np.array([len(a)]))
    top = (rows + cols) / 2
    return 1.0 if top == expected else float((both - expected) / (top - expected))


def edge_pairs(mat, cutoff):
    """Flat strict-upper-triangle indices of the reference's edge rule:
    r >= cutoff and r > 0."""
    m = mat.shape[0]
    keep = np.triu((mat >= cutoff) & (mat > 0), k=1)
    i, j = np.nonzero(keep)
    return i.astype(np.int64) * m + j


def phase_leiden(device, scale, state):
    """Communities: ``kmer_leiden`` on planted families at the reference's
    background size, dense and streamed, with its checks."""
    import importlib
    import os

    from seekr_tpu_torch import cli
    from seekr_tpu_torch.models.counter import KmerCounter
    from seekr_tpu_torch.models.pearson import pearson
    from seekr_tpu_torch.ops import count_cuda

    leiden = importlib.import_module("seekr_tpu_torch.graph.kmer_leiden")
    k, n_fam, members = scale.leiden_k, scale.leiden_families, scale.leiden_members
    seqs, truth = family_corpus(n_fam, members, scale.corpus_cap, state["seed"] + 8)
    state["families"] = (seqs, truth)  # phase 9's self run takes its head
    m = len(seqs)
    out = {"phase": "leiden", "card": state.get("smi"), "m": m, "k": k, "families": n_fam,
           "members": members, "mutation": LEIDEN_MUTATION, "cutoff": LEIDEN_CUTOFF,
           "native_library": state["native_library"]}
    build_dir = Path(__file__).resolve().parent / "seekr_tpu_torch" / "_build"
    if Path(state["native_library"]).parent != build_dir:
        raise AssertionError(f"the host library {state['native_library']} is not the "
                             f"port's own (under {build_dir})")
    run = dict(pearsoncutoff=LEIDEN_CUTOFF, setseed=True, device=device)

    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # set-up: the user's files, the norm vectors from the corpus itself
            write_fasta_file("families.fa", seqs)
            write_fasta_file("head.fa", seqs[:scale.leiden_dense_export])
            cli.main(["norm_vectors", "families.fa", "-k", str(k), "-mv", "mean.npy",
                      "-sv", "std.npy", "--device", str(device)])
            vectors = ("mean.npy", "std.npy")

            # -- the main path: dense, streamed with its Gephi export, and the
            # dense export on the head of the corpus --------------------------
            reset_launches()
            membership = leiden.kmer_leiden("families.fa", *vectors, k, **run)
            streamed = leiden.kmer_leiden("families.fa", *vectors, k, stream=True,
                                          csvfile="streamed", **run)
            head = leiden.kmer_leiden("head.fa", *vectors, k, stream=False, csvfile="dense",
                                      **run)
            read_launches(state, "leiden")
            if is_cuda(device) and count_cuda.launches["count_kmers_smem"] == 0:
                raise AssertionError("kmer_leiden never launched count_kmers_smem")

            # -- the stages again, one by one (not counted) ---------------------
            counts = KmerCounter("families.fa", mean=vectors[0], std=vectors[1], k=k,
                                 silent=True, device=device).get_counts_device()
            sim = pearson(counts, counts, device=device)

            # checks on the unthresholded similarity
            ref = f64_pearson_device(counts, counts)
            out["sim_max_abs_vs_f64"] = float(np.abs(sim - ref).max())
            near = np.abs(ref - LEIDEN_CUTOFF) <= 1e-4
            out["pairs_within_1e-4_of_cutoff"] = int(np.triu(near, k=1).sum())
            got_edges, ref_edges = edge_pairs(sim, LEIDEN_CUTOFF), edge_pairs(ref, LEIDEN_CUTOFF)
            flips = np.setxor1d(got_edges, ref_edges)
            out["edges"], out["edges_f64"] = len(got_edges), len(ref_edges)
            out["edge_flips_vs_f64"] = len(flips)
            out["edge_flips_away_from_cutoff"] = int((~near.ravel()[flips]).sum())
            del ref, near
            same_family = np.triu(truth[:, None] == truth[None, :], k=1)
            within = sim[same_family]
            rng = np.random.default_rng(state["seed"] + 9)
            ii, jj = rng.integers(0, m, size=(2, 1_000_000))
            across = sim[ii, jj][truth[ii] != truth[jj]]
            out["r_within_quantiles"] = dict(zip(map(str, LEIDEN_QUANTILES),
                                                 np.quantile(within, LEIDEN_QUANTILES).tolist()))
            out["r_across_quantiles"] = dict(zip(map(str, LEIDEN_QUANTILES),
                                                 np.quantile(across, LEIDEN_QUANTILES).tolist()))
            out["within_pairs_below_cutoff"] = int((within < LEIDEN_CUTOFF).sum())
            out["sampled_across_pairs_at_or_above_cutoff"] = int((across >= LEIDEN_CUTOFF).sum())
            del same_family, within, across

            sim[sim < LEIDEN_CUTOFF] = 0  # the threshold
            np.fill_diagonal(sim, 0)
            src, dst = np.nonzero(np.triu(sim > 0, k=1))
            w = sim[src, dst]
            again = leiden._run_leiden(src, dst, w, m, "RBERVertexPartition", 1.0, True)
            s_src, s_dst, _ = leiden.sparse_similarity_edges(counts, LEIDEN_CUTOFF, device=device)
            del sim

            # -- checks ------------------------------------------------------
            out["families_found"] = len(set(membership.tolist()))
            out["recovers_families"] = same_partition(membership, truth)
            if not out["recovers_families"]:
                out["adjusted_rand_index"] = adjusted_rand_index(membership, truth)
            out["seeded_runs_identical"] = bool(np.array_equal(membership, again))
            dense_set = set(zip(src.tolist(), dst.tolist()))
            streamed_set = set(zip(s_src.tolist(), s_dst.tolist()))
            differ = dense_set ^ streamed_set
            out["streamed_edge_differences"] = len(differ)
            r64 = None
            if differ:  # only GEMM-tiling ulps at the cutoff may tell the two apart
                r64 = np.array([f64_pearson_device(counts[i:i + 1], counts[j:j + 1])[0, 0]
                                     for i, j in differ])
            out["streamed_edges_match"] = r64 is None or bool(
                (np.abs(r64 - LEIDEN_CUTOFF) <= 1e-5).all())
            out["streamed_same_partition"] = same_partition(streamed, membership)
            nodes = Path("streamed_nodes_leiden.csv").read_text().splitlines()
            edges = Path("streamed_edges_leiden.csv").read_text().splitlines()
            out["streamed_export_rows"] = [len(nodes) - 1, len(edges) - 1]
            head_m = scale.leiden_dense_export
            dense_edges = Path("dense_edges_leiden.csv").read_text().splitlines()
            out["dense_export_head_rows"] = [
                len(Path("dense_nodes_leiden.csv").read_text().splitlines()) - 1,
                len(dense_edges) - 1]
            out["dense_export_head_communities"] = len(set(head.tolist()))
        finally:
            os.chdir(home)

    log(json.dumps(out))
    state["leiden"] = out
    failures = [name for name, ok in (
        ("similarity within 1e-4 of float64", out["sim_max_abs_vs_f64"] <= 1e-4),
        ("edge set equal to float64's away from the cutoff",
         out["edge_flips_away_from_cutoff"] == 0),
        ("the planted families, exactly", out["recovers_families"]),
        ("two seeded runs identical", out["seeded_runs_identical"]),
        ("streamed edges equal away from the cutoff", out["streamed_edges_match"]),
        ("streamed partition equal", out["streamed_same_partition"]),
        ("streamed export rows", out["streamed_export_rows"] == [m, len(streamed_set)]),
        ("dense export rows", out["dense_export_head_rows"]
         == [head_m, head_m * (head_m - 1) // 2]),
    ) if not ok]
    if failures:
        raise AssertionError(f"leiden checks failed: {failures}")


WF_CUTOFF = 0.2          # the Leiden stage's -lc, as phase 8's cutoff
ADJ_CROSS_METHODS = ("fdr_bh", "bonferroni", "holm", "fdr_by")
DATA_LEN_THRESHOLD = 1000  # filter_gencode -len of the data-tool run
DATA_ISOFORM = "00[12]"    # filter_gencode -iso of the data-tool run (regex)
DIRECT_BH_MAX = 20_000_000  # values up to which adj_case also holds fdr_bh to a direct BH


def plain_raw_counts(seqs, k, device):
    """Raw counts-per-kb [m, 4^k] in float64 by the plain version
    (``count_torch``), on ``device``."""
    import torch

    from seekr_tpu_torch.io.encode import encode_seqs
    from seekr_tpu_torch.ops.count import count_torch

    out = torch.zeros((len(seqs), 4 ** k), dtype=torch.float64, device=device)
    for b, n, ids in encode_seqs(seqs, k, max_rows_per_bucket=2048).buckets:
        c = count_torch(torch.as_tensor(b, device=device), torch.as_tensor(n, device=device), k)
        out[torch.as_tensor(ids, device=device)] = c[:len(ids)].to(torch.float64)
    return out


def f64_normalize(raw, mean=None, std=None):
    """Log2.post normalize in float64 (the column stats of ``raw`` where not
    given): center, scale, shift by the set's |min| and log2(x + 1)."""
    import torch

    mean = raw.mean(dim=0) if mean is None else mean
    c = raw - mean
    std = c.std(dim=0, correction=0) if std is None else std
    c = c / std
    return torch.log2(c + c.min().abs() + 1.0), mean, std


def adj_case(spec: dict) -> dict:
    """One ``adj_pval -bi`` case, run in a fresh process (``run_adj_case``):
    ``adj_pval_stream`` on the .npy, then the in-memory ``adj_pval`` on the same
    matrix (loading it included); the stream's value buckets and segments,
    whether each path found the matrix symmetric, and whether the two .npy
    results are bitwise equal and the two CSVs byte-equal."""
    import contextlib
    import hashlib
    import io
    import os
    import shutil

    sys.path.insert(0, spec["root"])
    from seekr_tpu_torch.io.fast_csv import LabeledMatrix
    from seekr_tpu_torch.stats import stream_adj
    from seekr_tpu_torch.stats.adj_pval import adj_pval

    def sha(path):
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 24), b""):
                h.update(chunk)
        return h.hexdigest()

    npy, prefix, method = spec["npy"], spec["prefix"], spec["method"]
    scratch = f"{prefix}_scratch"
    os.makedirs(scratch)
    segments = []
    segment_plan = stream_adj._bucket_segments

    def counted_segments(*args):
        segs = segment_plan(*args)
        segments.append((len(segs), sum(seg.equal for seg in segs)))
        return segs

    stream_adj._bucket_segments = counted_segments
    out = {"method": method, "max_bucket_pairs": spec.get("max_bucket_pairs")}
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        stream_adj.adj_pval_stream(npy, method, outputname=f"{prefix}_st",
                                   out_npy=f"{prefix}_st.npy", scratch_dir=scratch,
                                   max_bucket_pairs=spec.get("max_bucket_pairs"))
    out["stream_symmetric"] = "is a symmetric matrix" in said.getvalue()
    out["value_buckets"] = len(segments)
    out["segments"] = sum(n for n, _ in segments)
    out["all_equal_segments"] = sum(e for _, e in segments)
    shutil.rmtree(scratch)

    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        values = np.load(npy)
        m1, m2 = values.shape
        adj = adj_pval(LabeledMatrix(values, [str(i) for i in range(m1)],
                                     [str(j) for j in range(m2)]),
                       method, outputname=f"{prefix}_mem")
    out["memory_symmetric"] = "is a symmetric matrix" in said.getvalue()
    streamed = np.load(f"{prefix}_st.npy", mmap_mode="r")
    got = streamed.view(np.uint64)
    want = np.ascontiguousarray(adj.values).view(np.uint64)
    step = max(1, (1 << 24) // m2)
    out["npy_bitwise"] = streamed.shape == adj.values.shape and all(
        np.array_equal(got[i:i + step], want[i:i + step]) for i in range(0, m1, step))
    out["csv_bytes_equal"] = sha(f"{prefix}_st.csv") == sha(f"{prefix}_mem.csv")
    out["csv_bytes"] = os.path.getsize(f"{prefix}_st.csv")
    iu = np.triu_indices(m1, 1) if out["memory_symmetric"] else None
    p = values[iu] if iu is not None else values
    a = adj.values[iu] if iu is not None else adj.values
    if method == "fdr_bh" and p.size <= DIRECT_BH_MAX:
        out["max_abs_vs_direct_bh"] = float(np.abs(a.ravel() - direct_bh(p)).max())
    out["rejected_at_0.05"] = int((a <= 0.05).sum())
    del streamed, got
    for suffix in ("_st.npy", "_st.csv", "_mem.csv"):
        os.unlink(prefix + suffix)
    return out


def run_adj_case(here, spec) -> dict:
    """``adj_case`` in a subprocess; its JSON result."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "print(json.dumps(chip_smoke.adj_case(json.loads(sys.argv[2]))))")
    proc = subprocess.run([sys.executable, "-c", code, str(here), json.dumps(spec)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"adj_pval -bi case {spec} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def random_pwms(rng, n, lengths=(6, 12)):
    """``n`` PWM tables (positions x ACGU probabilities), 6-12 positions each."""
    return [rng.dirichlet(np.ones(4), size=int(rng.integers(lengths[0], lengths[1] + 1)))
            for _ in range(n)]


def write_pwm(path, table):
    rows = ["Pos\tA\tC\tG\tU"] + [f"{i + 1}\t" + "\t".join(repr(float(v)) for v in row)
                                  for i, row in enumerate(table)]
    Path(path).write_text("\n".join(rows) + "\n")


def pwm_weights(table, k):
    """The k-mer weights of one PWM table (ACGT columns), written out apart
    from ``CountsWeighter``: every placement of each k-mer's sub-words of
    length min(k, positions) inside the motif, the product of their bases'
    probabilities, summed."""
    col = {"A": 0, "C": 1, "G": 2, "T": 3}
    n = table.shape[0]
    w = min(k, n)
    out = np.zeros(4 ** k)
    for idx, letters in enumerate(itertools.product("AGTC", repeat=k)):
        total = 0.0
        for s in range(k - w + 1):
            word = letters[s:s + w]
            for start in range(n - w + 1):
                prod = 1.0
                for i, base in enumerate(word):
                    prod *= table[start + i, col[base]]
                total += prod
        out[idx] = total
    return out


def gencode_corpus(seqs, rng):
    """GENCODE-style headers for ``seqs`` and a GTF of their 'transcript' lines:
    genes of 1-4 isoforms numbered -001, -002, ... (a share 20x), transcript
    lengths in the header, about a third tagged Ensembl_canonical.  Returns
    (headers, gtf text, facts) with the facts a direct filter needs."""
    headers, lines, facts = [], ["##description: synthetic"], []
    gene, iso = 0, 0
    for i, s in enumerate(seqs):
        if iso == 0 or rng.random() < 0.45 or iso >= 4:
            gene, iso = gene + 1, 0
        iso += 1
        number = (200 if rng.random() < 0.25 else 0) + iso
        tid, name = f"ENST{i:011d}.1", f"G{gene}-{number:03d}"
        canonical = bool(rng.random() < 0.35)
        headers.append(f"{tid}|ENSG{gene:011d}.1|-|-|{name}|G{gene}|{len(s)}|")
        tag = 'tag "Ensembl_canonical"; ' if canonical else 'tag "basic"; '
        lines.append(f"chr1\tsyn\ttranscript\t1\t{len(s)}\t.\t+\t.\t"
                     f'gene_id "ENSG{gene:011d}.1"; transcript_id "{tid}"; '
                     f'transcript_name "{name}"; {tag}')
        lines.append(f"chr1\tsyn\texon\t1\t{len(s)}\t.\t+\t.\t"
                     f'transcript_id "{tid}"; tag "Ensembl_canonical";')
        facts.append((len(s), canonical, f"{number:03d}", name))
    return headers, "\n".join(lines) + "\n", facts


def fasta_records(path):
    from seekr_tpu_torch.io.fasta import Reader

    reader = Reader(str(path))
    return [h[1:] for h in reader.get_headers()], reader.get_seqs()


def phase_workflow(device, scale, state):
    """Phase 9: the one-shot workflow, the streamed correction, domain_pearson,
    pwms, the data tools and the doctor, with their checks."""
    import os
    import re

    import torch

    from seekr_tpu_torch import cli
    from seekr_tpu_torch.io.encode import encode_seqs
    from seekr_tpu_torch.io.fast_csv import read_labeled_csv
    from seekr_tpu_torch.io.fasta import write_fasta
    from seekr_tpu_torch.models.counter import KmerCounter
    from seekr_tpu_torch.models.domain import DomainPearson, percentile_of_scores, tile_windows
    from seekr_tpu_torch.models.pearson import pearson as port_pearson
    from seekr_tpu_torch.models.pwm import CountsWeighter
    from seekr_tpu_torch.models.workflow import run_workflow
    from seekr_tpu_torch.ops import count_cuda
    from seekr_tpu_torch.ops.count import count_graph
    from seekr_tpu_torch.ops.ecdf import SortedBackground
    from seekr_tpu_torch.ops.normalize import normalize_counts
    from seekr_tpu_torch.stats.find_pval import find_pval
    from seekr_tpu_torch.utils.adj import triu_index_to_ij

    here = Path(__file__).resolve().parent
    seqs, k, dev = state["seqs"], scale.wf_k, str(device)
    m, q = len(seqs), scale.stats_query
    fam_seqs, fam_truth = state["families"]
    n_fam = scale.wf_families * scale.leiden_members
    fam_seqs, fam_truth = fam_seqs[:n_fam], fam_truth[:n_fam]
    out = {"phase": "workflow", "card": state.get("smi"), "k": k, "background": m,
           "self_queries": n_fam, "cross": [q, m], "subset": scale.stats_subset}
    checks = {}
    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            write_fasta_file("corpus.fa", seqs)  # set-up: the user's files
            write_fasta_file("query.fa", seqs[:q])
            write_fasta_file("families.fa", fam_seqs)
            seed = state["seed"] + 10

            # -- pipeline: the self run with Leiden (API), the cross run (CLI) --
            reset_launches()
            res = run_workflow("families.fa", background="corpus.fa", k=k,
                               subset_size=scale.stats_subset, seed=seed, leiden=True,
                               leiden_cutoff=WF_CUTOFF, outdir="self", device=device)
            cli.main(["pipeline", "query.fa", "-s2", "corpus.fa", "-b", "corpus.fa",
                      "-k", str(k), "-sbs", str(scale.stats_subset), "-sd", str(seed),
                      "-o", "cross", "--device", dev])
            workflow_launches = count_cuda.launches["count_kmers_smem"]
            read_launches(state, "workflow")
            out["pipeline_smem_launches"] = workflow_launches
            if is_cuda(device) and workflow_launches == 0:
                raise AssertionError("the workflow never launched count_kmers_smem")

            # -- checks against the port's stepwise chain -----------------------
            mean, std = np.load(f"self/mean_{k}mers.npy"), np.load(f"self/std_{k}mers.npy")
            step = KmerCounter("corpus.fa", k=k, silent=True, device=device)
            bkg_counts = step.get_counts_device()
            out["norm_vectors_max_rel"] = float(max(
                np.abs(mean - step.mean).max() / np.abs(step.mean).max(),
                np.abs(std - step.std).max() / np.abs(step.std).max()))
            checks["norm vectors within 1e-6 relative"] = out["norm_vectors_max_rel"] <= 1e-6
            bkg_post = KmerCounter("corpus.fa", k=k, mean=mean, std=std, silent=True,
                                   device=device).get_counts_device()
            triu_n = m * (m - 1) // 2
            null = res["null_sample"]
            pick = np.random.default_rng(seed).choice(triu_n, size=min(scale.stats_subset,
                                                                       triu_n), replace=False)
            ii, jj = triu_index_to_ij(m, pick)
            ii_t, jj_t = (torch.as_tensor(np.asarray(a), device=device) for a in (ii, jj))
            std_rows = bkg_post.to(torch.float64)
            std_rows = std_rows - std_rows.mean(dim=1, keepdim=True)
            std_rows = std_rows / std_rows.std(dim=1, keepdim=True, correction=0)
            null64 = ((std_rows[ii_t] * std_rows[jj_t]).sum(dim=1) / (4 ** k)).cpu().numpy()
            del std_rows, ii_t, jj_t
            out["null_sample_max_abs_vs_f64"] = float(np.abs(null - null64).max())
            checks["null sample: the seeded draw, within 1e-4 of float64"] = (
                null.shape == (min(scale.stats_subset, triu_n),)
                and out["null_sample_max_abs_vs_f64"] <= 1e-4)

            runs = {"self": ("families.fa", None), "cross": ("query.fa", "corpus.fa")}
            for name, (fa1, fa2) in runs.items():
                c1 = KmerCounter(fa1, k=k, mean=mean, std=std, silent=True,
                                 device=device).get_counts_device()
                c2 = c1 if fa2 is None else bkg_post
                got_counts = read_labeled_csv(f"{name}/counts1.csv", dtype=np.float32).values
                got_r = read_labeled_csv(f"{name}/pearson.csv", dtype=np.float32).values
                got_p = read_labeled_csv(f"{name}/pvals.csv", dtype=np.float32).values
                got_adj = read_labeled_csv(f"{name}/pvals_adjusted.csv").values
                r64 = f64_pearson_device(c1, c2)
                r_err = float(np.abs(got_r - r64).max())
                # a p-value can differ only where a null value lies between r
                # and r64: within the largest |r - r64| of r64
                near = near_background(r64, null, tol=max(r_err, 1e-7))
                want_p = SortedBackground(null).pvals(r64).astype(np.float32)
                if fa2 is None:
                    iu = np.triu_indices(r64.shape[0], 1)
                    adj_got, adj_want = got_adj[iu], direct_bh(got_p[iu])
                    lower_nan = bool(np.isnan(got_adj[np.tril_indices(r64.shape[0])]).all())
                else:
                    adj_got, adj_want, lower_nan = got_adj.ravel(), direct_bh(got_p), True
                row = {"counts_max_abs": float(np.abs(got_counts - c1.cpu().numpy()).max()),
                       "r_max_abs_vs_f64": r_err,
                       "near_tie_share": float(near.mean()),
                       "share_within_1e-5_of_null": float(
                           near_background(r64, null, tol=1e-5).mean()),
                       "pvals_differ_away_from_ties": int((got_p != want_p)[~near].sum()),
                       "adj_max_abs_vs_direct_bh": float(np.abs(adj_got - adj_want).max()),
                       "adj_symmetric_fill": lower_nan,
                       "shape": list(got_r.shape)}
                out[f"check_{name}"] = row
                checks[f"{name}: counts within 1e-5"] = row["counts_max_abs"] <= 1e-5
                checks[f"{name}: r within 1e-4 of float64"] = row["r_max_abs_vs_f64"] <= 1e-4
                checks[f"{name}: p-values equal away from null ties"] = (
                    row["pvals_differ_away_from_ties"] == 0)
                checks[f"{name}: adjusted within 1e-12 of direct BH"] = (
                    row["adj_max_abs_vs_direct_bh"] <= 1e-12 and lower_nan)
                del c1
            membership = np.loadtxt("self/communities.csv", delimiter=",", skiprows=1,
                                    usecols=1, dtype=np.int64)
            out["families_found"] = len(set(membership.tolist()))
            checks["the planted families, exactly"] = (
                same_partition(membership, fam_truth)
                and np.array_equal(membership, res["communities"]))
            files = {"self": ["mean", "std", "counts1", "pearson", "pvals", "pvals_adjusted",
                              "communities"],
                     "cross": ["mean", "std", "counts1", "counts2", "pearson", "pvals",
                               "pvals_adjusted"]}
            present = all(os.path.isfile(f"{d}/{f}_{k}mers.npy" if f in ("mean", "std")
                                         else f"{d}/{f}.csv")
                          for d, names in files.items() for f in names)
            checks["every artifact present and re-readable"] = (
                present
                and read_labeled_csv("cross/counts2.csv", dtype=np.float32).shape
                == (m, 4 ** k)
                and read_labeled_csv("self/pvals.csv").shape == (n_fam, n_fam))
            del bkg_counts

            # -- adj_pval -bi on find_pval --stream -bo output ------------------
            np.save("null.npy", null)
            vectors = (f"self/mean_{k}mers.npy", f"self/std_{k}mers.npy")
            find_pval("corpus.fa", "corpus.fa", *vectors, k, null, stream=True,
                      npy_out="self_p.npy", device=device)
            find_pval("query.fa", "corpus.fa", *vectors, k, null, stream=True,
                      npy_out="cross_p.npy", device=device)
            self_p = np.load("self_p.npy", mmap_mode="r")
            out["self_pvals_exactly_symmetric"] = bool(all(
                np.array_equal(self_p[i:i + 1024, :], self_p[:, i:i + 1024].T)
                for i in range(0, m, 1024)))
            del self_p
            # the tie-mass case on the head rows: each forced segment is one
            # emit with its own file appends, so its sweep grows with their count
            np.save("cross_head_p.npy", np.load("cross_p.npy", mmap_mode="r")[:scale.adj_tie_rows])
            cases = [("self_p.npy", "fdr_bh", None)]
            cases += [("cross_p.npy", method, None) for method in ADJ_CROSS_METHODS]
            cases += [("cross_head_p.npy", "fdr_bh", scale.adj_tie_cap)]
            adj_rows = []
            for i, (npy, method, cap) in enumerate(cases):
                row = run_adj_case(here, {"root": str(here), "npy": os.path.abspath(npy),
                                          "method": method, "max_bucket_pairs": cap,
                                          "prefix": os.path.abspath(f"case{i}")})
                row["input"] = npy
                adj_rows.append(row)
                log(json.dumps({"phase": "workflow", "adj_pval_bi": row}))
            out["adj_pval_bi"] = adj_rows
            checks["adj_pval -bi: .npy bitwise and CSV byte-equal, every case"] = all(
                r["npy_bitwise"] and r["csv_bytes_equal"] for r in adj_rows)
            checks["adj_pval -bi: the self matrix detected symmetric by both paths"] = (
                adj_rows[0]["stream_symmetric"] and adj_rows[0]["memory_symmetric"])
            checks["adj_pval -bi: the bucket cap forced tie-mass segments"] = (
                adj_rows[-1]["segments"] > adj_rows[-1]["value_buckets"]
                and adj_rows[-1]["all_equal_segments"] > 0)
            checks["adj_pval -bi: fdr_bh within 1e-12 of direct BH"] = all(
                r["max_abs_vs_direct_bh"] <= 1e-12 for r in adj_rows
                if "max_abs_vs_direct_bh" in r)
            for name in ("self_p.npy", "cross_p.npy", "cross_head_p.npy"):
                os.unlink(name)

            # -- domain_pearson ---------------------------------------------
            write_fasta_file("dom_q.fa", seqs[:scale.dom_queries])
            write_fasta_file("dom_t.fa", seqs[:scale.dom_targets])
            window, slide = scale.dom_window
            reset_launches()
            dom = DomainPearson("dom_q.fa", "dom_t.fa", "corpus.fa", r_values_path="r.csv",
                                percentiles_path="pct.csv", k=k, window=window, slide=slide,
                                device=device)
            dom.run()
            dom_launches = count_cuda.launches["count_kmers_smem"]
            read_launches(state, "domain_pearson")
            if is_cuda(device) and dom_launches == 0:
                raise AssertionError("domain_pearson never launched count_kmers_smem")
            windows = [(f"t{i}", s, w) for i, t in enumerate(seqs[:scale.dom_targets])
                       for s, w in tile_windows(t, window, slide)]
            out["domain_windows"] = len(windows)
            ref_raw = plain_raw_counts(seqs, k, device).to(torch.float64)
            ref_n, ref_mean, ref_std = f64_normalize(ref_raw)
            q_n, _, _ = f64_normalize(plain_raw_counts(seqs[:scale.dom_queries], k, device),
                                      ref_mean, ref_std)
            w_n, _, _ = f64_normalize(plain_raw_counts([w for _, _, w in windows], k, device),
                                      ref_mean, ref_std)
            r64 = f64_pearson_device(w_n, q_n)
            null64 = f64_pearson_device(q_n, ref_n)
            out["domain_r_max_abs_vs_f64"] = float(np.abs(dom.r_values.values - r64).max())
            pct64 = np.stack([percentile_of_scores(null64[j], r64[:, j])
                              for j in range(r64.shape[1])], axis=1)
            # the port's own null (the same ops as run(), so the same bits): a
            # percentile moves only where a null value lies within both sides'
            # float32 errors of r64
            ref_norm, ref_mu, ref_sd = normalize_counts(dom._raw_for(seqs), log2_mode=dom.log2)
            null32 = port_pearson(dom._normalized(dom._raw_for(seqs[:scale.dom_queries]),
                                                  ref_mu, ref_sd), ref_norm, device=device)
            del ref_norm
            dom_err = (float(np.abs(dom.r_values.values - r64).max()),
                       float(np.abs(null32 - null64).max()))
            out["domain_null_max_abs_vs_f64"] = dom_err[1]
            tol = max(sum(dom_err), 1e-7)
            near = np.stack([near_background(r64[:, j], null64[j], tol=tol)
                             for j in range(r64.shape[1])], axis=1)
            out["domain_percentile_near_tie_share"] = float(near.mean())
            out["domain_share_within_1e-5_of_null"] = float(np.stack(
                [near_background(r64[:, j], null64[j], tol=1e-5)
                 for j in range(r64.shape[1])], axis=1).mean())
            # stored in r's float32, as seekr_tpu stores them
            out["domain_percentiles_differ_away_from_ties"] = int(
                (dom.percentiles.values != pct64.astype(np.float32))[~near].sum())
            del ref_raw, ref_n, w_n
            checks["domain: r within 1e-4 of float64"] = out["domain_r_max_abs_vs_f64"] <= 1e-4
            checks["domain: percentiles equal away from ties"] = (
                out["domain_percentiles_differ_away_from_ties"] == 0)
            checks["domain: window labels"] = (
                dom.window_labels == [f"{t}|{s}" for t, s, _ in windows]
                and read_labeled_csv("pct.csv").index == dom.window_labels)

            # -- pwms ------------------------------------------------------------
            pwm_rng = np.random.default_rng(seed + 1)
            tables = random_pwms(pwm_rng, scale.pwm_count)
            os.makedirs("pwms")
            for i, table in enumerate(tables):
                write_pwm(f"pwms/P{i:03d}.txt", table)
            fixture = here / "tests" / "fixtures" / "pwms" / "SYN1_0.6.txt"
            Path("pwms/SYN1_0.6.txt").write_bytes(fixture.read_bytes())
            reset_launches()
            pwm_counts = KmerCounter("corpus.fa", k=scale.pwm_k, silent=True,
                                     device=device).get_counts()
            scores = CountsWeighter("pwms", pwm_counts, k=scale.pwm_k,
                                    out_path="pwm_scores.csv").run()
            read_launches(state, "pwms")
            syn = np.loadtxt(fixture, skiprows=1)[:, 1:]
            want_w = np.stack([pwm_weights(t, scale.pwm_k) for t in tables + [syn]], axis=1)
            names = [f"P{i:03d}.txt" for i in range(len(tables))] + ["SYN1_0.6.txt"]
            order = np.argsort(names)
            want_scores = (pwm_counts.astype(np.float64) @ want_w[:, order]).T
            out["pwms_max_rel"] = float(np.abs(scores.values - want_scores).max()
                                        / np.abs(want_scores).max())
            checks["pwms: within 1e-9 relative of float64"] = (
                out["pwms_max_rel"] <= 1e-9 and scores.index == sorted(names)
                and read_labeled_csv("pwm_scores.csv").shape == (len(names), m))

            # -- data tools --------------------------------------------------------
            data_rng = np.random.default_rng(seed + 2)
            headers, gtf, facts = gencode_corpus(seqs, data_rng)
            write_fasta("gencode.fa", headers, seqs)
            Path("gencode.gtf").write_text(gtf)
            cli.main(["canonical_gencode", "gencode.fa", "canonical.fa", "--device", dev])
            cli.main(["filter_gencode", "gencode.fa", "-gtf", "gencode.gtf", "-len",
                      str(DATA_LEN_THRESHOLD), "-can", "-iso", DATA_ISOFORM, "-o", "filtered",
                      "--device", dev])
            canon_want = [h for h, f in zip(headers, facts) if f[3].endswith("-001")]
            filt_want = [h for h, f in zip(headers, facts)
                         if f[0] >= DATA_LEN_THRESHOLD and f[1]
                         and re.fullmatch(DATA_ISOFORM, f[2])]
            canon_got, canon_seqs = fasta_records("canonical.fa")
            filt_got, filt_seqs = fasta_records("filtered.fa")
            by_header = dict(zip(headers, seqs))
            out["data_kept"] = {"canonical_gencode": len(canon_got),
                                "filter_gencode": len(filt_got), "of": m}
            checks["data: canonical_gencode keeps the direct filter's records"] = (
                canon_got == canon_want and canon_seqs == [by_header[h] for h in canon_want])
            checks["data: filter_gencode keeps the direct filter's records"] = (
                filt_got == filt_want and filt_seqs == [by_header[h] for h in filt_want])
            write_fasta_file("rand_in.fa", seqs[:scale.rand_m])
            cli.main(["gen_rand_rnas", "rand_in.fa", "rand_out.fa", "-k", "2", "-s", str(seed),
                      "--device", dev])
            _, shuffled = fasta_records("rand_out.fa")
            originals = seqs[:scale.rand_m]
            out["gen_rand_rnas_changed"] = sum(a != b for a, b in zip(originals, shuffled))
            same = len(shuffled) == len(originals)
            for (b1, n1, ids1), (b2, n2, ids2) in zip(
                    encode_seqs(originals, 2, max_rows_per_bucket=2048).buckets,
                    encode_seqs(shuffled, 2, max_rows_per_bucket=2048).buckets):
                c1 = count_graph(torch.as_tensor(b1, device=device),
                                 torch.as_tensor(n1, device=device), 2, scaled=False)
                c2 = count_graph(torch.as_tensor(b2, device=device),
                                 torch.as_tensor(n2, device=device), 2, scaled=False)
                same &= np.array_equal(ids1, ids2) and bool(torch.equal(c1, c2))
            checks["data: gen_rand_rnas keeps every 2-mer count, bitwise"] = (
                same and out["gen_rand_rnas_changed"] > 0)

            # -- doctor ------------------------------------------------------------
            argv = [sys.executable, "-m", "seekr_tpu_torch.cli", "doctor"]
            if not is_cuda(device):
                argv.append("--no-device")
            proc = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=600)
            out["doctor_rc"] = proc.returncode
            out["doctor_report"] = proc.stdout.strip().splitlines()
            checks["doctor: exit 0, the card's name reported"] = proc.returncode == 0 and (
                not is_cuda(device) or torch.cuda.get_device_name(device) in proc.stdout)
        finally:
            os.chdir(home)

    out["checks"] = checks
    log(json.dumps(out))
    state["workflow"] = out
    failures = [name for name, ok in checks.items() if not ok]
    if failures:
        raise AssertionError(f"workflow checks failed: {failures}")


PLOT_METHOD = "complete"   # the linkage of kmer_heatmap's and kmer_dendrogram's defaults
PLOT_METRIC = "correlation"
PLOT_TOL = 1e-5            # device pdist against float64, and the merge-height gap
TEXT_WORDS = 10            # words of the textplot coordinates, the reference's maximum
DRAWING_NEEDS = {          # the packages each drawing entry point imports
    "kmer_heatmap": ("matplotlib", "seaborn"), "kmer_dendrogram": ("matplotlib",),
    "kmer_count_barplot": ("matplotlib", "seaborn"),
    "kmer_msd_barplot": ("matplotlib", "seaborn"), "kmer_comp_textplot": ("matplotlib",),
    "kmer_indi_textplot": ("matplotlib",), "visualize_distro": ("matplotlib",),
    "plot_fits": ("matplotlib",), "plot_network": ("matplotlib", "networkx"),
    "graph": ("networkx",),
}


def f64_distances(x, device):
    """[m, m] correlation distances of the rows of ``x`` in float64 on ``device``."""
    import torch

    c = torch.as_tensor(np.asarray(x), device=device).to(torch.float64)
    c = c - c.mean(dim=1, keepdim=True)
    c = c / torch.sqrt((c * c).sum(dim=1, keepdim=True))
    return 1.0 - c @ c.T


def condensed_err(got, full64) -> dict:
    """A condensed vector against the strict upper triangle of a float64 square:
    the largest and the 99.9th-percentile absolute difference over the values
    that are not NaN, whether the NaNs agree, and whether every value is within
    seekr_tpu's budget against scipy (rtol 1e-4 / atol 1e-5)."""
    from seekr_tpu_torch.utils.adj import triu_values

    want = triu_values(np.ascontiguousarray(full64))
    nan = np.isnan(want)
    diff = np.abs(got[~nan] - want[~nan])
    return {"max_abs": float(diff.max()) if diff.size else 0.0,
            "p99_9_abs": float(np.quantile(diff, 0.999)) if diff.size else 0.0,
            "same_nan": bool(np.array_equal(np.isnan(got), nan)),
            "within_rtol_1e-4_atol_1e-5": bool(np.allclose(got, want, rtol=1e-4, atol=1e-5,
                                                           equal_nan=True))}


def order_within(order, keys, ascending: bool, tol: float) -> bool:
    """Whether ``keys[order]`` is sorted up to ``tol``: no two positions out of
    order whose keys differ by more than ``tol``."""
    k = np.asarray(keys, np.float64)[np.asarray(order)]
    if not ascending:
        k = -k
    return bool((np.maximum.accumulate(k) - k <= tol).all())


def word_scan(seq: str, word: str) -> list:
    """Positions covered by ``word`` in ``seq``, by comparing every window."""
    s = np.frombuffer(seq.encode(), np.uint8)
    w = np.frombuffer(word.encode(), np.uint8)
    if len(w) > len(s):
        return []
    windows = np.lib.stride_tricks.sliding_window_view(s, len(w))
    starts = np.nonzero((windows == w).all(axis=1))[0]
    return np.unique(starts[:, None] + np.arange(len(w))).tolist()


def leaf_agreement(d_got, d_f64, method) -> dict:
    """Leaf orders of ``linkage`` over two condensed vectors: equal, or where two
    float64 merge heights lie within ``PLOT_TOL`` the share of equal leaves."""
    from scipy.cluster.hierarchy import leaves_list, linkage

    z64 = linkage(d_f64, method)
    a, b = leaves_list(linkage(d_got, method)), leaves_list(z64)
    gap = float(np.diff(np.sort(z64[:, 2])).min()) if len(z64) > 1 else np.inf
    out = {"min_f64_height_gap": gap, "leaves_equal": bool(np.array_equal(a, b)),
           "equal_leaf_share": float(np.mean(a == b))}
    out["holds"] = out["leaves_equal"] or gap <= PLOT_TOL
    return out


@contextmanager
def pdist_route(rows, cols):
    """``pdist_auto``'s own routing where it sends [rows, cols] to the card; at a
    rehearsal's size, where it would not, ``SEEKR_TPU_PDIST=device`` forces it.
    Yields whether the route was forced."""
    import os

    from seekr_tpu_torch.ops.dist import use_device_pdist

    forced = not use_device_pdist(rows, cols, PLOT_METRIC)
    before = os.environ.get("SEEKR_TPU_PDIST")
    if forced:
        os.environ["SEEKR_TPU_PDIST"] = "device"
    try:
        yield forced
    finally:
        if before is None:
            os.environ.pop("SEEKR_TPU_PDIST", None)
        else:
            os.environ["SEEKR_TPU_PDIST"] = before


def drawing_branch(device, seqs, seed) -> dict:
    """Each drawing entry point: drawn (tiny inputs, 72 dpi) where the packages it
    imports are installed, else it must raise ModuleNotFoundError naming one of
    the missing ones."""
    import importlib
    import importlib.util

    from seekr_tpu_torch.graph.kmer_leiden import plot_network
    from seekr_tpu_torch.graph.maker import Maker
    from seekr_tpu_torch.io.fast_csv import LabeledMatrix
    from seekr_tpu_torch.stats.find_dist import plot_fits
    from seekr_tpu_torch.viz import (kmer_comp_textplot, kmer_count_barplot,
                                     kmer_dendrogram, kmer_heatmap, kmer_indi_textplot,
                                     kmer_msd_barplot, visualize_distro)

    missing = [p for p in ("matplotlib", "seaborn", "networkx")
               if importlib.util.find_spec(p) is None]
    write_fasta_file("draw.fa", [s[:60] for s in seqs[:12]])
    sim = np.corrcoef(np.random.default_rng(seed).normal(size=(6, 20)))
    names = [f"t{i}" for i in range(6)]
    small = LabeledMatrix(sim, names, names)
    np.save("draw_sim.npy", sim)
    graph = LabeledMatrix(np.where(sim > 0, sim, 0.0) - np.eye(6), names, names)
    fits = [("norm", 0.01, (0.0, 1.0)), ("expon", 0.02, (0.0, 1.0))]
    k, vectors = 2, ("draw_mean.npy", "draw_std.npy")
    np.save(vectors[0], np.zeros(16))
    np.save(vectors[1], np.ones(16))
    calls = {
        "kmer_heatmap": lambda: kmer_heatmap(small, -1, 1, outputname="d_heat", hformat="png",
                                             hdpi=72, device=device),
        "kmer_dendrogram": lambda: kmer_dendrogram(small, outputname="d_dendro", pformat="png",
                                                   pdpi=72, device=device),
        "kmer_count_barplot": lambda: kmer_count_barplot("draw.fa", *vectors, k,
                                                         outputname="d_count", pformat="png",
                                                         pdpi=72, device=device),
        "kmer_msd_barplot": lambda: kmer_msd_barplot("draw.fa", *vectors, k, outputname="d_msd",
                                                     pformat="png", pdpi=72, device=device),
        "kmer_comp_textplot": lambda: kmer_comp_textplot("draw.fa", "draw.fa", ["AC", "GT"],
                                                         outputname="d_comp", plotformat="png",
                                                         plotdpi=72),
        "kmer_indi_textplot": lambda: kmer_indi_textplot("draw.fa", ["AC"], outputpath="d_indi_",
                                                         plotformat="png", plotdpi=72),
        "visualize_distro": lambda: visualize_distro("draw_sim.npy", outputname="d_distro",
                                                     pformat="png", pdpi=72),
        "plot_fits": lambda: plot_fits(sim.ravel(), fits, "d_fits"),
        "plot_network": lambda: plot_network(graph, np.arange(6) % 2, "d_network"),
        "graph": lambda: Maker("draw_sim.npy", gml_path="d_graph.gml",
                               csv_path="d_graph.csv", seed=0).make_gml_csv_files(),
    }
    out = {"missing": missing, "drawn": [], "raised": {}}
    before = set(Path(".").iterdir())
    for name, call in calls.items():
        absent = [p for p in DRAWING_NEEDS[name] if p in missing]
        if not absent:
            call()
            out["drawn"].append(name)
            continue
        try:
            call()
        except ModuleNotFoundError as err:
            if err.name not in absent:
                raise
            out["raised"][name] = err.name
        else:
            raise AssertionError(f"{name} ran without {absent}")
    written = [p for p in set(Path(".").iterdir()) - before if p.name.startswith("d_")]
    out["files_written"] = len(written)
    out["files_non_empty"] = all(p.stat().st_size > 0 for p in written)
    return out


def phase_plots(device, scale, state):
    """Phase 10: the plots' and graphs' compute on the card at the reference's
    background size, ``help``, and the drawing entry points."""
    import os

    import torch
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import pdist

    from seekr_tpu_torch import cli
    from seekr_tpu_torch.io.fast_csv import LabeledMatrix
    from seekr_tpu_torch.models.counter import KmerCounter
    from seekr_tpu_torch.models.pearson import mirror_upper_inplace
    from seekr_tpu_torch.ops import count_cuda
    from seekr_tpu_torch.ops.dist import distance_matrix, pdist_device
    from seekr_tpu_torch.utils.adj import triu_values
    from seekr_tpu_torch.viz import long_form
    from seekr_tpu_torch.viz.kmer_count_barplot import _barplot_rows
    from seekr_tpu_torch.viz.kmer_dendrogram import _dendrogram_linkage
    from seekr_tpu_torch.viz.kmer_heatmap import _cluster_orders
    from seekr_tpu_torch.viz.kmer_msd_barplot import _msd_rows
    from seekr_tpu_torch.viz.textplot import find_word_coordinates
    from seekr_tpu_torch.viz.visualize_distro import stream_distro_stats

    here = Path(__file__).resolve().parent
    fam_seqs, truth = state["families"]
    seqs, k = state["seqs"], scale.leiden_k
    m, n = len(fam_seqs), 4 ** k
    check_rows = min(scale.plot_check_rows, m)
    out = {"phase": "plots", "card": state.get("smi"), "k": k, "profiles": [m, n]}
    checks = {}
    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            write_fasta_file("families.fa", fam_seqs)  # set-up: the user's files
            write_fasta_file("corpus.fa", seqs)
            cli.main(["norm_vectors", "corpus.fa", "-k", str(k), "-mv", "mean.npy", "-sv",
                      "std.npy", "--device", str(device)])

            # -- the main path: the dendrogram's profiles and both directions,
            # the heatmap's orders, the barplots' counts and rows ---------------
            reset_launches()
            counter = KmerCounter("families.fa", k=k, silent=True, device=device)
            profiles = counter.get_counts()
            labeled = LabeledMatrix(profiles, [h[1:] for h in counter.headers], counter.kmers)
            with pdist_route(m, n) as forced:
                out["pdist_forced_to_device"] = forced
                z_row, _, n_leaves = _dendrogram_linkage(labeled, "row", PLOT_METRIC,
                                                         PLOT_METHOD, device)
                z_col, _, _ = _dendrogram_linkage(labeled, "column", PLOT_METRIC,
                                                  PLOT_METHOD, device)
            hm = min(scale.heatmap_rows, state["sim"].shape[0])
            block = np.ascontiguousarray(state["sim"][:hm, :hm])
            with pdist_route(hm, hm) as forced:
                out["heatmap_pdist_forced_to_device"] = forced
                _, row_order, _, col_order = _cluster_orders(block, PLOT_METRIC, PLOT_METHOD,
                                                             device)
            headers, counts, kmers = long_form.counted_profiles(
                "corpus.fa", "mean.npy", "std.npy", k, "Log2.post", device)
            count_rows = _barplot_rows(headers, counts, kmers, "ascending", 10)
            mean_rows = _msd_rows(headers, counts, kmers, "mean", "descending", 10)
            sd_rows = _msd_rows(headers, counts, kmers, "sd", "ascending", 10)
            smem = count_cuda.launches["count_kmers_smem"]
            read_launches(state, "plots")
            out["smem_launches"] = smem
            if is_cuda(device) and smem == 0:
                raise AssertionError("the plots' counting never launched count_kmers_smem")

            # -- the dendrogram's pdist, step by step (not counted) ---------------
            x = torch.as_tensor(profiles, device=device)
            d_row = triu_values(distance_matrix(x, PLOT_METRIC).cpu().numpy().astype(np.float64))
            z_again = linkage(d_row, PLOT_METHOD)
            checks["the entry path's linkage equals the step-by-step one"] = bool(
                np.array_equal(z_row, z_again))
            del z_again

            # -- checks ------------------------------------------------------------
            full64 = f64_distances(profiles, device).cpu().numpy()
            err = out["row_pdist_vs_f64"] = condensed_err(d_row, full64)
            checks["row pdist within 1e-5 of float64, NaN where NaN"] = (
                err["same_nan"] and err["max_abs"] <= PLOT_TOL)
            del full64, d_row
            # the columns sum 13,000 products per distance, where the rows sum
            # 4,096: they are held to seekr_tpu's budget against scipy instead
            col64 = f64_distances(profiles.T, device).cpu().numpy()
            d_col = pdist_device(profiles.T, PLOT_METRIC, device=device)
            err = out["column_pdist_vs_f64"] = condensed_err(d_col, col64)
            checks["column pdist within rtol 1e-4 / atol 1e-5 of float64, NaN where NaN"] = (
                err["same_nan"] and err["within_rtol_1e-4_atol_1e-5"])
            del col64, d_col
            head = profiles[:check_rows]
            d_head = pdist_device(head, PLOT_METRIC, device=device)
            d_scipy = pdist(head.astype(np.float64), PLOT_METRIC)
            out["head_rows"] = check_rows
            out["head_pdist_max_abs_vs_scipy"] = float(np.abs(d_head - d_scipy).max())
            checks["head pdist within rtol 1e-4 / atol 1e-5 of scipy"] = bool(
                np.allclose(d_head, d_scipy, rtol=1e-4, atol=1e-5))
            out["head_leaves"] = leaf_agreement(d_head, d_scipy, PLOT_METHOD)
            checks["head leaf order equal to float64's where no merge heights tie"] = (
                out["head_leaves"]["holds"])
            clusters = fcluster(z_row, int(truth.max()) + 1, "maxclust")
            out["families_adjusted_rand_index"] = adjusted_rand_index(clusters, truth)
            out["column_linkage_rows"] = len(z_col)
            checks["the card's pdist routed by use_device_pdist itself (rehearsals force it)"] = (
                not is_cuda(device) or not (out["pdist_forced_to_device"]
                                            or out["heatmap_pdist_forced_to_device"]))
            checks["linkages have m - 1 merges"] = (len(z_row) == m - 1
                                                    and len(z_col) == n - 1
                                                    and n_leaves == m)

            block64 = f64_distances(block, device).cpu().numpy()
            d_block = pdist_device(block, PLOT_METRIC, device=device)
            err = out["heatmap_pdist_vs_f64"] = condensed_err(d_block, block64)
            checks["heatmap pdist within 1e-5 of float64, NaN where NaN"] = (
                err["same_nan"] and err["max_abs"] <= PLOT_TOL)
            checks["heatmap orders are permutations"] = (
                sorted(row_order.tolist()) == list(range(hm))
                and sorted(col_order.tolist()) == list(range(hm)))
            del block64, d_block

            mean_v, std_v = (torch.as_tensor(np.load(f), device=device, dtype=torch.float64)
                             for f in ("mean.npy", "std.npy"))
            counts64 = f64_normalize(plain_raw_counts(seqs, k, device), mean_v,
                                     std_v)[0].cpu().numpy()
            out["barplot_counts_max_abs_vs_f64"] = float(np.abs(counts - counts64).max())
            checks["barplot counts within 1e-5 of float64"] = (
                out["barplot_counts_max_abs_vs_f64"] <= PLOT_TOL)
            index = {w: j for j, w in enumerate(kmers)}
            head10 = counts64[:10]
            orders = {
                "count ascending": (count_rows, np.abs(head10 - head10.mean(0)).sum(0), True),
                "msd mean descending": (mean_rows, counts64.mean(0), False),
                "msd sd ascending": (sd_rows, counts64.std(0, ddof=1), True)}
            for name, (rows, keys, ascending) in orders.items():
                samples = len(set(rows["Sample"]))  # each word's rows are consecutive
                order = [index[w] for w in rows["Kword"][::samples]]
                checks[f"barplot {name} order equal to float64's away from 1e-5 ties"] = (
                    order_within(order, keys, ascending, PLOT_TOL))
            out["barplot_rows"] = [len(r["Kword"]) for r in (count_rows, mean_rows, sd_rows)]
            checks["barplot rows: 10 words of 10 samples, 10 of every sequence"] = (
                out["barplot_rows"] == [10 * min(10, len(headers)), 10 * len(headers),
                                        10 * len(headers)])
            del counts64

            # -- textplot coordinates ----------------------------------------------
            rng = np.random.default_rng(state["seed"] + 12)
            words = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(2, 7))))
                     for _ in range(TEXT_WORDS)]
            coords = [[find_word_coordinates(s, w).tolist() for w in words]
                      for s in state["long_pair"]]
            out["word_positions"] = [sum(len(c) for c in cs) for cs in coords]
            checks["word coordinates equal to a window scan"] = all(
                c == word_scan(s, w) for s, cs in zip(state["long_pair"], coords)
                for w, c in zip(words, cs))

            # -- visualize_distro's streamed statistics ------------------------------
            sim = state["sim"].copy()
            mirror_upper_inplace(sim)
            np.save("sim.npy", sim)
            del sim
            counts_h, edges, n_vals, mean, sd, median = stream_distro_stats("sim.npy")
            vals = triu_values(np.load("sim.npy").astype(np.float64))
            vals = vals[np.isfinite(vals)]
            fine = (edges[-1] - edges[0]) / (1 << 20)
            rank = (vals.size + 1) // 2 - 1  # the value whose fine bin the stream reports
            middle = float(np.partition(vals, rank)[rank])
            out["distro"] = {"n": n_vals, "mean": mean, "sd": sd, "median_approx": median,
                             "f64_mean": float(vals.mean()), "f64_sd": float(vals.std()),
                             "f64_middle_value": middle, "f64_median": float(np.median(vals)),
                             "fine_bin": fine}
            checks["distro n exact"] = n_vals == vals.size
            checks["distro mean and sd within 1e-9 relative of float64"] = bool(
                abs(mean - vals.mean()) <= 1e-9 * abs(vals.mean())
                and abs(sd - vals.std()) <= 1e-9 * vals.std())
            checks["distro median within one fine bin of the middle value"] = bool(
                abs(median - middle) <= fine)
            checks["distro histogram holds every value"] = int(counts_h.sum()) == n_vals
            del vals

            # -- help in a fresh process, and the drawing --------------------------
            proc = subprocess.run([sys.executable, "-m", "seekr_tpu_torch.cli", "help"],
                                  cwd=here, capture_output=True, text=True, timeout=600)
            lines = proc.stdout.splitlines()
            sections = [lines[i + 1] for i in range(len(lines) - 2)
                        if lines[i] == lines[i + 2] == "=" * 25]
            out["help_sections"] = len(sections)
            checks["help: one section per command, every flag table built"] = (
                proc.returncode == 0 and sections == [c for c in cli.COMMANDS if c != "help"]
                and len(sections) == 25 and "flag table unavailable" not in proc.stdout)
            drawing = drawing_branch(device, seqs, state["seed"] + 11)
            out["drawing"] = drawing
            if drawing["missing"]:
                log(f"drawing: {', '.join(drawing['missing'])} not installed; the drawing "
                    f"and graph are held on the CPU by tests/test_torch_viz*.py "
                    f"(entry points raised ModuleNotFoundError: {drawing['raised']})")
            else:
                log(f"drawing: every entry point drew ({len(drawing['drawn'])})")
            checks["drawing: each entry point drew or named its missing package"] = (
                len(drawing["drawn"]) + len(drawing["raised"]) == len(DRAWING_NEEDS)
                and drawing["files_non_empty"])
        finally:
            os.chdir(home)

    out["checks"] = checks
    log(json.dumps(out))
    state["plots"] = out
    failures = [name for name, ok in checks.items() if not ok]
    if failures:
        raise AssertionError(f"plots checks failed: {failures}")


MESH_SHARDS_ON_ONE_CARD = 4  # a mesh on one card (or the CPU): four shards of it


def mesh_devices(device):
    """(devices, cards): every visible card, or four shards of the one card (of
    the CPU in the rehearsal)."""
    import torch

    if not is_cuda(device):
        return [torch.device("cpu")] * MESH_SHARDS_ON_ONE_CARD, 0
    cards = torch.cuda.device_count()
    if cards == 1:
        return [torch.device(device)] * MESH_SHARDS_ON_ONE_CARD, 1
    return [torch.device("cuda", i) for i in range(cards)], cards


@contextmanager
def data_parallel_on_shards(cards):
    """Below two cards, ``data_parallel=N`` (the library's mesh flags) resolves
    to N shards of the one device: the library itself refuses more devices than
    cards, as the CLI check shows.  With more cards nothing is changed."""
    import torch

    from seekr_tpu_torch.parallel import mesh as mesh_mod

    if cards > 1:
        yield
        return
    real = mesh_mod.build_mesh_from_flags

    def shards(data_parallel, kmer_parallel=1, device=None, **_):
        kp = max(kmer_parallel or 1, 1)
        dp = data_parallel or (1 if kp > 1 else 0)
        if dp * kp <= 1:
            return None
        return mesh_mod.make_mesh([torch.device(device)] * (dp * kp), kmer_parallel=kp)

    mesh_mod.build_mesh_from_flags = shards
    try:
        yield
    finally:
        mesh_mod.build_mesh_from_flags = real


@contextmanager
def counted(state, name):
    """A main-path section: launch counts set to 0 before it and read after it
    (into the kernels line); yields the section's own launches, filled at exit."""
    from seekr_tpu_torch.ops import count_cuda

    reset_launches()
    launched = {}
    yield launched
    launched.update(count_cuda.launches)
    read_launches(state, name)


def sync_all(devices) -> None:
    for dev in {str(d): d for d in devices}.values():
        sync(dev)


class _TileDiff:
    """Writer holding streamed tiles against the rows of a reference matrix."""

    def __init__(self, ref):
        self.ref, self.row, self.max_abs = ref, 0, 0.0

    def append(self, tile):
        rows = self.ref[self.row:self.row + tile.shape[0]]
        self.max_abs = max(self.max_abs, float(np.abs(tile - rows).max()))
        self.row += tile.shape[0]


def close_on_device(a, b, rtol=1e-4, atol=1e-5):
    """(allclose with NaN where NaN, max abs of the finite differences)."""
    import torch

    b = b.to(a.device)
    ok = bool(torch.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True))
    diff = (a - b).abs()
    diff = diff[torch.isfinite(diff)]
    return ok, float(diff.max()) if diff.numel() else 0.0


def phase_mesh(device, scale, state):
    """Phase 11: the device mesh in one process (``seekr_tpu_torch.parallel``) on
    every visible card, or four shards of the one card: the sharded pipeline, the
    norm statistics, the kmer axis at k = 9, the long sequence, the streamed
    Pearson, the mesh callers, the CLI's -dp, the sharded service and a
    checkpoint, each held against its single-device run."""
    import importlib
    import os

    import torch

    from seekr_tpu_torch import cli
    from seekr_tpu_torch.io.checkpoint import load_sharded, save_sharded
    from seekr_tpu_torch.io.stream import stream_pearson
    from seekr_tpu_torch.models.pipeline import SeekrPipeline
    from seekr_tpu_torch.ops.count import count_graph, count_kmers_long, count_torch
    from seekr_tpu_torch.ops.normalize import normalize_graph
    from seekr_tpu_torch.ops import pearson as pearson_ops
    from seekr_tpu_torch.ops.pearson import _RowFiller
    from seekr_tpu_torch.parallel import dist
    from seekr_tpu_torch.parallel.mesh import make_mesh, row_col_sharding
    from seekr_tpu_torch.serve import SeekrService
    from seekr_tpu_torch.stats import find_dist, find_pval

    leiden = importlib.import_module("seekr_tpu_torch.graph.kmer_leiden")
    devices, cards = mesh_devices(device)
    n = len(devices)
    mesh = make_mesh(devices)
    grid = make_mesh((devices * 4)[:4], kmer_parallel=2)
    out = {"phase": "mesh", "card": state.get("smi"), "cards": cards, "shards": n,
           "kmer_grid": [2, 2]}
    checks = {}
    seed, dev = state["seed"], str(device)

    # -- the sharded pipeline, phase 3's corpus at k = 6 ----------------------
    bases, lengths = state["corpus"]
    m = bases.shape[0] - bases.shape[0] % n  # rows divide the data axis
    bt = torch.as_tensor(bases[:m], device=device)
    nt = torch.as_tensor(lengths[:m], device=device)
    pipe = SeekrPipeline(k=PIPELINE_K, device=device)
    ref_counts, ref_mean, ref_std = pipe.counts(bt, nt)  # the single device
    ref_sim = pipe.forward(bt, nt)
    step = dist.distributed_pipeline(mesh, k=PIPELINE_K)
    with counted(state, "mesh: pipeline") as launched:
        for _ in range(scale.mesh_reps + 1):
            got = step(bt, nt)
        parts = dist._sharded_count(mesh, bt, nt, PIPELINE_K)
        three = dist.distributed_pipeline(mesh, k=PIPELINE_K, flat=False)(bt, nt)
        vec = dist.distributed_pipeline(mesh, k=PIPELINE_K, use_norm_vectors=True)(
            bt, nt, ref_mean, ref_std)
        stats = dist.distributed_norm_stats(mesh, k=PIPELINE_K)(bt, nt)
        sync_all(devices)
    out.update(rows=m, k=PIPELINE_K, pipeline_launches=dict(launched))
    checks["pipeline launched count_kmers_smem per shard"] = (
        not is_cuda(device) or launched["count_kmers_smem"] >= n * (scale.mesh_reps + 1))
    whole = count_graph(bt, nt, PIPELINE_K)
    m_loc = m // n
    checks["counts per shard bitwise"] = all(
        torch.equal(part.to(device), whole[i * m_loc:(i + 1) * m_loc])
        for i, part in enumerate(parts))
    del parts, whole
    for name, (a, b) in {"normalized": (got[0].gather(device), ref_counts),
                         "mean": (got[1].gather(device), ref_mean),
                         "std": (got[2].gather(device), ref_std),
                         "flat=False normalized": (
                             three[0].gather(device).reshape(m, -1), ref_counts),
                         "norm-vector normalized": (vec[0].gather(device), ref_counts)}.items():
        checks[f"pipeline {name} within rtol 1e-4 / atol 1e-5"], err = close_on_device(a, b)
        out[f"pipeline_{name.replace(' ', '_').replace('=', '_')}_max_abs"] = err
    for name, sim in (("r", got[3]), ("flat=False r", three[3]), ("norm-vector r", vec[3])):
        err = float((sim.gather(device) - ref_sim).abs().max())
        out[f"pipeline_{name.replace(' ', '_').replace('=', '_')}_max_abs"] = err
        checks[f"pipeline {name} within 1e-4"] = err <= 1e-4
    raw = count_graph(bt, nt, PIPELINE_K)
    _, raw_mean, raw_std = normalize_graph(raw, None, None, "Log2.none")
    for name, (a, b) in {"mean": (stats[0].gather(device), raw_mean),
                         "std": (stats[1].gather(device), raw_std)}.items():
        checks[f"norm stats {name} within rtol 1e-4 / atol 1e-5"], err = close_on_device(a, b)
        out[f"norm_stats_{name}_max_abs"] = err
    normalized = ref_counts
    sharded_counts = got[0]
    del got, three, vec, stats, raw, ref_sim

    # -- the kmer axis: a (2, 2) grid at k = 9 ----------------------------------
    kb, kn = make_corpus(scale.mesh_kmer_m, scale.corpus_cap, seed + 11)
    kbt, knt = torch.as_tensor(kb, device=device), torch.as_tensor(kn, device=device)
    raw = count_graph(kbt, knt, LARGE_K)
    _, kmean, kstd = normalize_graph(raw, None, None, "Log2.none")
    kstd = torch.where(kstd > 0, kstd, torch.ones_like(kstd))  # finite vectors
    del raw
    kpipe = SeekrPipeline(k=LARGE_K, log2="Log2.none", device=device)
    with counted(state, "mesh: kmer axis") as launched:
        kgot = dist.distributed_pipeline(grid, k=LARGE_K, log2="Log2.none",
                                         use_norm_vectors=True)(kbt, knt, kmean, kstd)
    out["kmer_axis"] = {"rows": scale.mesh_kmer_m, "k": LARGE_K,
                        "count_bytes": scale.mesh_kmer_m * 4 ** LARGE_K * 4,
                        "launches": dict(launched)}
    checks["kmer axis launched count_kmers_hiblocked per data shard"] = (
        not is_cuda(device) or launched["count_kmers_hiblocked"] >= 2)
    kref = kpipe.counts(kbt, knt, kmean, kstd)[0]
    checks["kmer axis normalized within rtol 1e-4 / atol 1e-5"], err = close_on_device(
        kgot[0].gather(device), kref)
    out["kmer_axis"]["normalized_max_abs"] = err
    r64 = f64_pearson_device(kref, kref)  # 262,144-term sums: held to float64
    del kref
    r_mesh = kgot[3].gather(device).cpu().numpy()
    r_one = kpipe.forward(kbt, knt, kmean, kstd).cpu().numpy()
    chunk, pearson_ops.GEMM_CHUNK = pearson_ops.GEMM_CHUNK, 4 ** LARGE_K
    try:  # the contraction as one product, as before ops.pearson.gram: a reading
        r_whole = kpipe.forward(kbt, knt, kmean, kstd).cpu().numpy()
    finally:
        pearson_ops.GEMM_CHUNK = chunk
    out["kmer_axis"].update(
        r_max_abs_vs_f64=float(np.abs(r_mesh - r64).max()),
        single_r_max_abs_vs_f64=float(np.abs(r_one - r64).max()),
        single_one_product_r_max_abs_vs_f64=float(np.abs(r_whole - r64).max()),
        r_max_abs_vs_single=float(np.abs(r_mesh - r_one).max()))
    checks["kmer axis r within 1e-4 of float64"] = \
        out["kmer_axis"]["r_max_abs_vs_f64"] <= 1e-4
    checks["the single path's k = 9 r within 1e-4 of float64"] = \
        out["kmer_axis"]["single_r_max_abs_vs_f64"] <= 1e-4
    del kgot, kbt, knt, r64, r_mesh, r_one, r_whole

    # -- the long sequence ------------------------------------------------------
    rng = np.random.default_rng(seed + 12)
    digits = rng.integers(0, 4, size=scale.mesh_long_len, dtype=np.int8)
    digits[rng.random(scale.mesh_long_len) < 5e-4] = 4
    chunks, n_windows = dist.shard_long_sequence(digits, PIPELINE_K, mesh.size)
    with counted(state, "mesh: long sequence"):
        long_got = dist.count_long_sequence(mesh, PIPELINE_K)(chunks, np.float32(n_windows))
    long_ref = count_torch(torch.as_tensor(digits[None], device=device),
                           torch.tensor([len(digits)], dtype=torch.int32, device=device),
                           PIPELINE_K)[0]
    checks["long sequence bitwise the whole-row count"] = bool(
        torch.equal(long_got.to(device), long_ref))
    out["long_sequence"] = {"bases": len(digits), "windows": int(n_windows),
                            "max_abs_vs_count_kmers_long": float(np.abs(
                                long_got.cpu().numpy()
                                - count_kmers_long(digits, PIPELINE_K, device=device)).max())}

    # -- the streamed Pearson, self and cross -----------------------------------
    q, s = scale.stats_query, scale.stats_self
    full, sharded = (np.empty((m, m), dtype=np.float32) for _ in range(2))
    stream_pearson(normalized, normalized, _RowFiller(full), device=device)
    filler = _RowFiller(sharded)  # the same writer as the single run's
    with counted(state, "mesh: stream_pearson_sharded"):
        dist.stream_pearson_sharded(mesh, normalized, filler)
    out["stream_self_max_abs"] = float(np.abs(sharded - full).max())
    checks["streamed self within 1e-4"] = filler.row == m and \
        out["stream_self_max_abs"] <= 1e-4
    del sharded
    cross = _TileDiff(full[:q])
    with counted(state, "mesh: stream_pearson_sharded cross"):
        dist.stream_pearson_sharded(mesh, normalized[:q], cross, counts2=normalized)
    out["stream_cross_max_abs"] = cross.max_abs
    checks["streamed cross within 1e-4"] = cross.row == q and cross.max_abs <= 1e-4
    del full

    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            seqs = state["seqs"]
            write_fasta_file("corpus.fa", seqs)  # set-up: the user's files
            write_fasta_file("query.fa", seqs[:q])
            write_fasta_file("self.fa", seqs[:s])
            vectors = (f"bkg_mean_{STATS_K}mers.npy", f"bkg_std_{STATS_K}mers.npy")

            # -- the mesh callers: find_dist, find_pval, kmer_leiden ---------
            with data_parallel_on_shards(cards), counted(state, "mesh: callers"):
                np.random.seed(seed)  # phase 6's draw, on the mesh
                bkg = find_dist("corpus.fa", k_mer=STATS_K, subset_size=scale.stats_subset,
                                fit_model=False, data_parallel=n, device=device)
                fitres = [("norm", 0.0, (float(bkg.mean()), float(bkg.std())))]
                p_mesh = find_pval("query.fa", "corpus.fa", *vectors, STATS_K, fitres,
                                   data_parallel=n, device=device)
                p_self = find_pval("self.fa", "self.fa", *vectors, STATS_K, fitres,
                                   data_parallel=n, device=device)
            err = float(np.abs(bkg - state["stats_background"]).max())
            out["find_dist_max_abs_vs_phase_6"] = err
            checks["find_dist within 1e-5 of phase 6's single-card draw"] = (
                bkg.shape == state["stats_background"].shape and err <= 1e-5)
            p_one = find_pval("query.fa", "corpus.fa", *vectors, STATS_K, fitres, device=device)
            err = float(np.abs(p_mesh.values - p_one.values).max())
            out["find_pval_max_abs_vs_single"] = err
            checks["find_pval within 1e-5 of the single card"] = (
                p_mesh.index == p_one.index and err <= 1e-5)
            checks["find_pval self exactly symmetric"] = bool(
                np.array_equal(p_self.values, p_self.values.T))

            fam_seqs, fam_truth = state["families"]
            n_fam = scale.wf_families * scale.leiden_members
            write_fasta_file("families.fa", fam_seqs[:n_fam])
            cli.main(["norm_vectors", "families.fa", "-k", str(scale.leiden_k), "-mv",
                      "fam_mean.npy", "-sv", "fam_std.npy", "--device", dev])
            run = ("families.fa", "fam_mean.npy", "fam_std.npy", scale.leiden_k)
            with data_parallel_on_shards(cards), counted(state, "mesh: kmer_leiden"):
                members = leiden.kmer_leiden(*run, pearsoncutoff=LEIDEN_CUTOFF, setseed=True,
                                             data_parallel=n, device=device)
            alone = leiden.kmer_leiden(*run, pearsoncutoff=LEIDEN_CUTOFF, setseed=True,
                                       stream=True, device=device)
            checks["kmer_leiden membership equal to the single card"] = bool(
                np.array_equal(members, alone))
            checks["kmer_leiden finds the planted families"] = same_partition(
                members, fam_truth[:n_fam])

            # -- the CLI: -dp N needs N cards ----------------------------------
            n_sample = min(1000, q * (q - 1) // 2)
            argv = ["find_dist", "query.fa", "-k", str(STATS_K), "-sbt", "-sbs", str(n_sample),
                    "-o", "cli_mesh", "--device", dev]
            if cards == 1:
                try:
                    cli.main(argv + ["-dp", str(n)])
                    out["cli_dp"] = "ran"
                except ValueError as err:
                    out["cli_dp"] = str(err)
                checks["find_dist -dp 4 refused on one card"] = out["cli_dp"] == (
                    f"requested {n} devices (data_parallel={n} x kmer_parallel=1), have 1")
            else:
                with counted(state, "mesh: CLI"):
                    cli.main(argv + ["-dp", str(n)])
                out["cli_dp"] = f"-dp {n} ran"
                checks[f"find_dist -dp {n} wrote its sample"] = \
                    np.loadtxt("cli_mesh.csv", delimiter=",").shape == (n_sample,)

            # -- the service on the mesh ---------------------------------------
            write_fasta_file("targets.fa", seqs)
            raw = count_graph(torch.as_tensor(bases, device=device),
                              torch.as_tensor(lengths, device=device), SERVE_K)
            _, smean, sstd = normalize_graph(raw, None, None, "Log2.none")
            del raw
            np.save("s_mean.npy", smean.cpu().numpy())
            np.save("s_std.npy", sstd.cpu().numpy())
            svec = ("s_mean.npy", "s_std.npy")
            rng = np.random.default_rng(seed + 13)
            q1 = [random_queries(rng, 1) for _ in range(scale.serve_rounds * scale.serve_q1)]
            big = [random_queries(rng, scale.serve_big_q)
                   for _ in range(scale.serve_rounds * scale.serve_big)]
            check_q = random_queries(rng, SERVE_CHECK_Q)
            grow_in, grow_across = (random_queries(rng, k) for k in scale.serve_grow)
            one = SeekrService(*svec, k=SERVE_K, targets="targets.fa",
                               grow_quantum=SERVE_QUANTUM, device=device)
            one.warmup()
            with counted(state, "mesh: service") as launched:
                svc = SeekrService(*svec, k=SERVE_K, targets="targets.fa",
                                   grow_quantum=SERVE_QUANTUM, mesh=mesh, device=device)
                rows_at_load = svc._resident_rows()
                svc.warmup()
                sims = [(svc.query(b)["sim"], one.query(b)["sim"]) for b in q1]
                tops = [(svc.query(b, want=("topk",), topk=SERVE_TOPK),
                         one.query(b, want=("topk",), topk=SERVE_TOPK + 1)) for b in big]
                before = svc.query(check_q)["sim"]
                svc.add_targets(grow_in)
                within = svc.query(check_q)["sim"]
                svc.add_targets(grow_across)
                grown = svc.query(check_q)["sim"]
                rows_after = svc._resident_rows()
                svc.save_corpus("mesh.npz")
                loaded = SeekrService(*svec, k=SERVE_K, targets="mesh.npz",
                                      grow_quantum=SERVE_QUANTUM, mesh=mesh, device=device)
                reloaded = loaded.query(check_q)["sim"]
            out["serve_launches"] = dict(launched)
            out["serve_resident_rows"] = {"targets": len(seqs), "at_load": rows_at_load,
                                          "after_growth": rows_after}
            err = max(float(np.abs(a - b).max()) for a, b in sims)
            out["serve_sim_max_abs_vs_single"] = err
            checks["service sim within 1e-6 of the single card"] = err <= 1e-6
            checks["service top-k agrees with the single card"] = all(
                topk_agrees(a["topk_sim"], a["topk_idx"], b["topk_sim"], b["topk_idx"])
                for a, b in tops)
            checks["service grow within the quantum bitwise"] = bool(
                np.array_equal(within[:, :len(seqs)], before))
            n_grown = len(seqs) + sum(scale.serve_grow)
            checks["service grow across the quantum"] = bool(
                np.abs(grown[:, :len(seqs)] - before).max() <= 1e-5
                and rows_after == svc._scorer.prospective_rows(n_grown))
            checks["service snapshot reload bitwise"] = bool(np.array_equal(reloaded, grown))
            del one, svc, loaded

            # -- a checkpoint of the sharded counts ----------------------------
            with counted(state, "mesh: checkpoint"):
                save_sharded("ckpt", sharded_counts)
                back = load_sharded("ckpt", sharding=row_col_sharding(grid))
            checks["checkpoint round trip bitwise onto the (2, 2) grid"] = bool(torch.equal(
                back.gather(device), sharded_counts.gather(device)))
            out["checkpoint_bytes"] = m * 4 ** PIPELINE_K * 4
        finally:
            os.chdir(home)

    out["checks"] = checks
    log(json.dumps(out))
    state["mesh"] = out
    failures = [name for name, ok in checks.items() if not ok]
    if failures:
        raise AssertionError(f"mesh checks failed: {failures}")


POD_PROCESSES = 2          # processes of phase 12's mesh
POD_TIMEOUT_S = 10         # SEEKR_TPU_POD_TIMEOUT of the killed-follower pod
POD_DEAD_TARGETS = 1000    # targets of the killed-follower pod
CHILD_TAG = "CHILD "       # the prefix of a phase 12 child's JSON line


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(pid: int, cards: int, extra=None) -> dict:
    """A phase 12 child's environment: the repository importable and, with a
    card for every process, only its own card visible: the ``pid``-th of this
    process's ``CUDA_VISIBLE_DEVICES`` where that is set."""
    import os

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent), **(extra or {}))
    if cards >= POD_PROCESSES:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        env["CUDA_VISIBLE_DEVICES"] = visible.split(",")[pid].strip() if visible else str(pid)
    return env


def start_children(args_of, cards, cwd=None, extra_env=None):
    """One ``chip_smoke.py --child`` process per pod process; ``args_of(pid,
    coordinator)`` gives its arguments."""
    coordinator = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--child",
                              *args_of(pid, coordinator)],
                             cwd=None if cwd is None else cwd(pid), env=child_env(
                                 pid, cards, extra_env),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(POD_PROCESSES)]


def stop_children(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait(timeout=60)


def child_results(procs, timeout, what):
    """Wait for every child (``timeout`` s in all); each must exit 0.  Returns
    their JSON lines (None where a child printed none)."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        stop_children(procs)
        raise AssertionError(f"{what}: a process did not finish within {timeout} s")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{what}: process {pid} exited {p.returncode}:\n{out[-4000:]}")
    return [next((json.loads(line[len(CHILD_TAG):]) for line in out.splitlines()
                  if line.startswith(CHILD_TAG)), None) for out in outs]


def wait_for_socket(path, procs, timeout):
    from seekr_tpu_torch.serve import request

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for pid, p in enumerate(procs):
            if p.poll() is not None:
                raise AssertionError(f"pod process {pid} exited {p.returncode} before "
                                     f"serving:\n{p.communicate()[0][-4000:]}")
        try:
            if request(path, {"op": "ping"}, timeout=10)["ok"]:
                return
        except OSError:
            pass
        time.sleep(0.25)
    raise AssertionError(f"the pod never answered on {path} within {timeout} s")


def child_pipeline(scale, seed: int, coordinator: str, pid: int, device: str) -> dict:
    """One process of phase 12 (a): ``distributed_pipeline`` on the corpus over
    the processes' mesh, its shards held against this process's own
    one-process mesh of the same grid and against ``SeekrPipeline.forward``."""
    import torch

    from seekr_tpu_torch.models.pipeline import SeekrPipeline
    from seekr_tpu_torch.ops import count_cuda
    from seekr_tpu_torch.parallel import comm, dist
    from seekr_tpu_torch.parallel.mesh import Mesh, make_mesh

    dev = torch.device(device)
    comm.init_distributed(coordinator, POD_PROCESSES, pid, device=dev)
    mesh = make_mesh([dev])
    bases, lengths = make_corpus(scale.corpus_m, scale.corpus_cap, seed)
    bt, nt = torch.as_tensor(bases, device=dev), torch.as_tensor(lengths, device=dev)
    step = dist.distributed_pipeline(mesh, k=PIPELINE_K)
    reset_launches()
    for _ in range(scale.mesh_reps + 1):
        got = step(bt, nt)
    launches = dict(count_cuda.launches)

    # comparisons, not counted: the one-process mesh of the same grid, the forward
    one = dist.distributed_pipeline(Mesh([[dev]] * POD_PROCESSES), k=PIPELINE_K)(bt, nt)
    out = {"role": "pipeline", "pid": pid, "backends": comm.backends(),
           "mesh_positions": mesh.local_positions, "launches": launches}

    def held(tensor):
        return {tuple((sl.start, sl.stop) for sl in s.index): s.data
                for s in tensor.addressable_shards}

    mine_c, ref_c = held(got[0]), held(one[0])
    mine_s, ref_s = held(got[3]), held(one[3])
    out["counts_bitwise_vs_one_process"] = all(torch.equal(x, ref_c[key])
                                               for key, x in mine_c.items())
    out["sim_max_abs_vs_one_process"] = max(float((x - ref_s[key]).abs().max())
                                            for key, x in mine_s.items())
    out["sim_bitwise_vs_one_process"] = all(torch.equal(x, ref_s[key])
                                            for key, x in mine_s.items())
    out["mean_std_bitwise_vs_one_process"] = all(
        torch.equal(a.addressable_shards[0].data, b.addressable_shards[0].data)
        for a, b in ((got[1], one[1]), (got[2], one[2])))
    del one
    pipe = SeekrPipeline(k=PIPELINE_K, device=dev)
    ref_counts = pipe.counts(bt, nt)[0]
    ref_sim = pipe.forward(bt, nt)
    errs, oks = [], []
    for key, x in mine_c.items():
        ok, err = close_on_device(x, ref_counts[key[0][0]:key[0][1], key[1][0]:key[1][1]])
        oks.append(ok)
        errs.append(err)
    out["counts_within_rtol_1e-4_of_forward"] = all(oks)
    out["counts_max_abs_vs_forward"] = max(errs)
    out["sim_max_abs_vs_forward"] = max(
        float((x - ref_sim[key[0][0]:key[0][1]]).abs().max()) for key, x in mine_s.items())
    return out


def child_cli(argv) -> dict:
    """One process of phase 12 (b)-(d): the port's command line as a user runs
    it; its launches after it returns."""
    from seekr_tpu_torch import cli
    from seekr_tpu_torch.ops import count_cuda
    from seekr_tpu_torch.parallel import comm

    reset_launches()
    cli.main(list(argv))
    return {"role": "cli", "pid": comm.process_index(), "backends": comm.backends(),
            "launches": dict(count_cuda.launches)}


def child_main(argv) -> int:
    """``chip_smoke.py --child pipeline SCALE SEED COORDINATOR PID DEVICE`` or
    ``--child cli ARGV...``: one process of phase 12; its result is the last
    line starting with ``CHILD ``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    role, rest = argv[0], argv[1:]
    if role == "pipeline":
        scale, seed, coordinator, pid, device = rest
        result = child_pipeline({"full": FULL, "tiny": TINY}[scale], int(seed), coordinator,
                                int(pid), device)
    else:
        result = child_cli(rest)
    print(CHILD_TAG + json.dumps(result), flush=True)
    return 0


def add_child_launches(state, results, what) -> dict:
    """Add the children's launches to the main-path counts (the kernels line)."""
    from seekr_tpu_torch.ops import count_cuda

    total = dict.fromkeys(count_cuda.KERNELS, 0)
    for result in results:
        for name, n in (result or {}).get("launches", {}).items():
            total[name] += n
    main = state.setdefault("launches", dict.fromkeys(count_cuda.KERNELS, 0))
    for name, n in total.items():
        main[name] += n
    log(f"{what}: the processes' kernel launches {total}")
    return total


def phase_processes(device, scale, state):
    """Phase 12: the mesh across processes.  Two processes joined by
    ``torch.distributed`` (one per card where there are two, else both on the
    one card, gloo through pinned host memory): the pipeline on the corpus,
    the CLI's pod serve on phase 7's targets, a killed follower, and the CLI's
    pipeline, each held against one process."""
    import os
    import signal

    import torch

    from seekr_tpu_torch import cli
    from seekr_tpu_torch.ops.count import count_graph
    from seekr_tpu_torch.ops.normalize import normalize_graph
    from seekr_tpu_torch.serve import SeekrService, request, serve_forever

    cuda = is_cuda(device)
    cards = torch.cuda.device_count() if cuda else 0
    child_dev = "cuda:0" if cuda else "cpu"
    cpu_flag = [] if cuda else ["--device", "cpu"]
    scale_name = "full" if scale is FULL else "tiny"
    out = {"phase": "processes", "card": state.get("smi"), "cards": cards,
           "processes": POD_PROCESSES, "placement": ("a card each" if cards >= POD_PROCESSES
                                                    else "one shared device")}
    checks = {}
    seed = state["seed"]

    # -- (a) distributed_pipeline over the processes ---------------------------
    procs = start_children(lambda pid, coord: ["pipeline", scale_name, str(seed), coord,
                                               str(pid), child_dev], cards)
    try:
        results = child_results(procs, 600, "(a) pipeline")
    finally:
        stop_children(procs)
    launched = add_child_launches(state, results, "processes: pipeline")
    bases, lengths = state["corpus"]
    out["backends"] = results[0]["backends"]
    log(f"process groups: {out['backends']}")
    out["pipeline"] = {
        "rows": int(bases.shape[0]), "k": PIPELINE_K, "launches": launched,
        "sim_max_abs_vs_one_process": max(r["sim_max_abs_vs_one_process"] for r in results),
        "sim_bitwise_vs_one_process": all(r["sim_bitwise_vs_one_process"] for r in results),
        "counts_max_abs_vs_forward": max(r["counts_max_abs_vs_forward"] for r in results),
        "sim_max_abs_vs_forward": max(r["sim_max_abs_vs_forward"] for r in results)}
    checks["(a) counts, mean, std bitwise the one-process mesh"] = all(
        r["counts_bitwise_vs_one_process"] and r["mean_std_bitwise_vs_one_process"]
        for r in results)
    checks["(a) sim within 1e-6 of the one-process mesh"] = \
        out["pipeline"]["sim_max_abs_vs_one_process"] <= 1e-6
    checks["(a) within 1e-4 of phase 3's forward"] = all(
        r["counts_within_rtol_1e-4_of_forward"] for r in results) and \
        out["pipeline"]["sim_max_abs_vs_forward"] <= 1e-4
    checks["(a) the processes launched count_kmers_smem"] = (
        not cuda or launched["count_kmers_smem"] >= POD_PROCESSES * (scale.mesh_reps + 1))
    checks["(a) each process holds its own rows"] = sorted(
        tuple(map(tuple, r["mesh_positions"])) for r in results) == [((0, 0),), ((1, 0),)]

    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        procs = []
        try:
            seqs = state["seqs"]
            write_fasta_file("targets.fa", seqs)
            raw = count_graph(torch.as_tensor(bases, device=device),
                              torch.as_tensor(lengths, device=device), SERVE_K)
            _, smean, sstd = normalize_graph(raw, None, None, "Log2.none")
            del raw
            np.save("s_mean.npy", smean.cpu().numpy())
            np.save("s_std.npy", sstd.cpu().numpy())
            svec = ["s_mean.npy", "s_std.npy"]
            rng = np.random.default_rng(seed + 14)
            q1 = [random_queries(rng, 1) for _ in range(scale.serve_rounds * scale.serve_q1)]
            big = [random_queries(rng, scale.serve_big_q)
                   for _ in range(scale.serve_rounds * scale.serve_big)]
            check_q = random_queries(rng, SERVE_CHECK_Q)
            grow_in = random_queries(rng, scale.serve_grow[0])

            # -- (b) the CLI's pod serve ---------------------------------------
            serve_args = ["serve", *svec, "-k", str(SERVE_K), "-t", "targets.fa",
                          "--grow-quantum", str(SERVE_QUANTUM), "-dp", str(POD_PROCESSES),
                          "--num_processes", str(POD_PROCESSES)] + cpu_flag
            procs = start_children(lambda pid, coord: ["cli", *serve_args, "--socket",
                                                       os.path.join(tmp, "pod.sock"),
                                                       "--process_id", str(pid),
                                                       "--coordinator", coord], cards)
            wait_for_socket("pod.sock", procs, 600)
            one = SeekrService(*svec, k=SERVE_K, targets="targets.fa",
                               grow_quantum=SERVE_QUANTUM, device=device)
            one.warmup()
            import threading

            ready = threading.Event()
            server = threading.Thread(target=serve_forever, args=(one, "one.sock", ready),
                                      daemon=True)
            server.start()
            if not ready.wait(60):
                raise AssertionError("the single-card socket server never came up")

            def ask(path, seqs_, want, topk=SERVE_TOPK):
                answer = request(path, {"seqs": seqs_, "want": list(want), "topk": topk},
                                 timeout=300)
                if not answer.get("ok"):
                    raise AssertionError(f"{path}: {answer}")
                return answer

            # the pod and the single card beside it, query by query
            sims = [(np.asarray(ask("pod.sock", b, ("sim",))["sim"]),
                     np.asarray(ask("one.sock", b, ("sim",))["sim"])) for b in q1]
            tops = [(ask("pod.sock", b, ("topk",)), ask("one.sock", b, ("topk",), SERVE_TOPK + 1))
                    for b in big]
            grown = request("pod.sock", {"op": "add_targets", "seqs": grow_in}, timeout=300)
            one.add_targets(grow_in)
            after_pod = np.asarray(ask("pod.sock", check_q, ("sim",))["sim"])
            after_one = np.asarray(ask("one.sock", check_q, ("sim",))["sim"])
            request("one.sock", {"op": "shutdown"}, timeout=60)
            server.join(timeout=60)
            down = request("pod.sock", {"op": "shutdown"}, timeout=60)
            results = child_results(procs, 120, "(b) pod serve")
            launched = add_child_launches(state, results, "processes: pod serve")
            out["serve"] = {
                "targets": len(seqs), "k": SERVE_K, "launches": launched,
                "sim_max_abs_vs_one": max(float(np.abs(a - b).max()) for a, b in sims),
                "after_grow_max_abs_vs_one": float(np.abs(after_pod - after_one).max())}
            checks["(b) the pod's sim within 1e-6 of the single card"] = \
                out["serve"]["sim_max_abs_vs_one"] <= 1e-6
            checks["(b) the pod's top-k agrees with the single card"] = all(
                topk_agrees(np.asarray(a["topk_sim"]), np.asarray(a["topk_idx"]),
                            np.asarray(b["topk_sim"]), np.asarray(b["topk_idx"]))
                for a, b in tops)
            checks["(b) add_targets grew the pod"] = bool(
                grown.get("ok") and grown["n"] == len(seqs) + len(grow_in)
                and after_pod.shape == (SERVE_CHECK_Q, len(seqs) + len(grow_in))
                and out["serve"]["after_grow_max_abs_vs_one"] <= 1e-6)
            checks["(b) shutdown: both processes exited 0"] = bool(down.get("ok"))
            checks["(b) the processes launched count_kmers_smem"] = (
                not cuda or launched["count_kmers_smem"] > 0)
            del one

            # -- (c) a killed follower -------------------------------------------
            write_fasta_file("small.fa", seqs[:POD_DEAD_TARGETS])
            dead_args = ["serve", *svec, "-k", str(SERVE_K), "-t", "small.fa", "--no-warmup",
                         "-dp", str(POD_PROCESSES), "--num_processes",
                         str(POD_PROCESSES)] + cpu_flag
            procs = start_children(lambda pid, coord: ["cli", *dead_args, "--socket",
                                                       os.path.join(tmp, "dead.sock"),
                                                       "--process_id", str(pid),
                                                       "--coordinator", coord], cards,
                                   extra_env={"SEEKR_TPU_POD_TIMEOUT": str(POD_TIMEOUT_S)})
            wait_for_socket("dead.sock", procs, 600)
            ask("dead.sock", check_q, ("topk",))
            procs[1].send_signal(signal.SIGKILL)
            procs[1].wait(timeout=60)
            # the two waits are checks: each is held to its limit below
            t0 = time.perf_counter()
            lost = request("dead.sock", {"seqs": check_q, "want": ["topk"],
                                         "topk": SERVE_TOPK}, timeout=120)
            lost_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = request("dead.sock", {"seqs": check_q, "want": ["sim"]}, timeout=120)
            again_s = time.perf_counter() - t0
            request("dead.sock", {"op": "shutdown"}, timeout=60)
            leader_rc = procs[0].wait(timeout=120)
            out["killed_follower"] = {"timeout_s": POD_TIMEOUT_S, "error_after_s": lost_s,
                                      "error": str(lost.get("error"))[:300],
                                      "next_error_after_s": again_s, "leader_rc": leader_rc}
            checks["(c) the client got the unresponsive error within the deadline"] = (
                lost.get("ok") is False and "unresponsive" in str(lost.get("error"))
                and lost_s <= POD_TIMEOUT_S + 5)
            checks["(c) later requests fail fast and the leader exits 0"] = (
                again.get("ok") is False and again_s <= 5 and leader_rc == 0)

            # -- (d) the CLI's pipeline over the processes ------------------------
            write_fasta_file("q.fa", seqs[:scale.stats_query])
            write_fasta_file("bkg.fa", seqs[:scale.stats_self])
            run = ["pipeline", os.path.join(tmp, "q.fa"), "-b", os.path.join(tmp, "bkg.fa"),
                   "-k", str(PIPELINE_K), "-sd", "0", "-o", "out"] + cpu_flag
            for pid in range(POD_PROCESSES):
                os.makedirs(f"p{pid}")
            procs = start_children(lambda pid, coord: ["cli", *run, "-dp", str(POD_PROCESSES),
                                                       "--num_processes", str(POD_PROCESSES),
                                                       "--process_id", str(pid),
                                                       "--coordinator", coord], cards,
                                   cwd=lambda pid: os.path.join(tmp, f"p{pid}"))
            results = child_results(procs, 600, "(d) pipeline")
            launched = add_child_launches(state, results, "processes: CLI pipeline")
            os.makedirs("mesh")
            os.makedirs("single")
            with data_parallel_on_shards(cards):
                os.chdir("mesh")
                cli.main(run + ["-dp", str(POD_PROCESSES)])
                os.chdir(tmp)
            os.chdir("single")
            cli.main(run)
            os.chdir(tmp)
            written = sorted(os.listdir("p0/out"))
            out["cli_pipeline"] = {"queries": scale.stats_query, "background": scale.stats_self,
                                   "artifacts": written, "launches": launched}
            checks["(d) only process 0 wrote"] = not os.path.exists("p1/out")
            checks["(d) artifacts byte-equal to the one-process mesh"] = (
                written == sorted(os.listdir("mesh/out")) and all(
                    Path("p0/out", name).read_bytes() == Path("mesh/out", name).read_bytes()
                    for name in written))
            same = [name for name in written
                    if Path("p0/out", name).read_bytes() == Path("single/out", name).read_bytes()]
            out["cli_pipeline"]["byte_equal_to_single_card"] = same
            from seekr_tpu_torch.io.fast_csv import read_labeled_csv

            r_pod = read_labeled_csv("p0/out/pearson.csv").values
            r_one = read_labeled_csv("single/out/pearson.csv").values
            finite = np.isfinite(r_pod)
            err = float(np.abs(r_pod[finite] - r_one[finite]).max()) if finite.any() else 0.0
            out["cli_pipeline"]["pearson_max_abs_vs_single_card"] = err
            checks["(d) counts and norm vectors byte-equal to the single card, r within "
                   "1e-5"] = ({"counts1.csv", f"mean_{PIPELINE_K}mers.npy",
                               f"std_{PIPELINE_K}mers.npy"} <= set(same) and err <= 1e-5
                              and np.array_equal(finite, np.isfinite(r_one)))
            checks["(d) the processes launched count_kmers_smem"] = (
                not cuda or launched["count_kmers_smem"] > 0)
        finally:
            stop_children(procs)
            os.chdir(home)

    out["checks"] = checks
    log(json.dumps(out))
    state["processes"] = out
    failures = [name for name, ok in checks.items() if not ok]
    if failures:
        raise AssertionError(f"process checks failed: {failures}")


PHASES = (phase_env, phase_kernels, phase_pipeline, phase_counter, phase_timing,
          phase_stats, phase_serve, phase_leiden, phase_workflow, phase_plots, phase_mesh,
          phase_processes)


def run(device, scale, seed: int = 0, phases=PHASES) -> dict:
    """Run ``phases`` in order; any failure raises.  Returns the state."""
    state = {"seed": seed}
    for phase in phases:
        log(f"== {phase.__name__}")
        phase(device, scale, state)
    return state


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--child"]:
        return child_main(argv[1:])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; nothing was run", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if not (here / "seekr_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no seekr_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    from seekr_tpu_torch.ops import count_cuda, epilogue_cuda

    device = torch.device("cuda", 0)
    state = run(device, FULL, args.seed)
    launches = {**state["launches"], **state["epilogue_launches"], SYM_GEMM: state[SYM_GEMM]}
    idle = [name for name in (*count_cuda.KERNELS, *epilogue_cuda.KERNELS, SYM_GEMM)
            if launches[name] == 0]
    if idle:
        raise AssertionError(f"kernels of the main path never launched: {idle}")
    for row in state["kernels"]:  # phase 6 launched after phase 5 built the rows
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": state["kernels"]}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
