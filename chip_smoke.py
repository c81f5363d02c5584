#!/usr/bin/env python3
"""Drive the seekr_tpu_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one NVIDIA card, ``nvcc`` and
PyTorch built for CUDA.  It builds the CUDA kernels from ``seekr_tpu_torch/csrc``
and runs these phases, each a function of (device, scale, state):

1. environment: torch and CUDA versions, ``nvcc --version``, the card's name and
   power limit, the kernel build (with ptxas' register and spill lines), and the
   host C++ library's g++ build (its path and build time);
2. every count kernel against its plain PyTorch version (``count_torch``) at
   k = 1..12 and 15, with N bases, short, zero-length and padded rows, and at
   k >= 8 a row whose windows hit both edges of the hi-blocked kernel's slices,
   scaled and raw, flat and unflattened; and at k = 9 two rows of one repeated
   code whose bins pass 65,535: bitwise equal (``torch.equal``);
3. the main path through ``SeekrPipeline(k=6, log2="Log2.post").forward`` on a
   synthetic stand-in of the reference's default background corpus (12,996
   GENCODE vM25 lncRNAs: here 13,000 transcripts with lognormal lengths, median
   about 1.4 kb, capped at 4,096), timed, and checked against a float64
   recomputation of normalize + Pearson from the kernel's counts (max abs 1e-4);
   the self Gram's route (``ops.pearson.gram_routes``: the split TF32 product
   by default), its GEMM kernels' names and its time and r error against
   float64 are printed beside the float32 product's;
4. the same corpus through ``KmerCounter(fasta).get_counts()`` and ``pearson``
   (the blocked path): exactly symmetric, within 1e-4 of phase 3; a FASTA with
   two transcripts past the long-sequence threshold against the numpy oracle;
   and ``KmerCounter(k=9)`` (the large-k kernel) against the numpy oracle; then
   the same counter with the Python parse and encode forced, for its
   time, and its counts bitwise those of the native parse and encode;
5. each kernel at its main-path shapes: its time (and per launch), its bound
   (and the share of it reached), the plain version's time and a library
   yardstick; for the hi-blocked kernel also a write-only pass over the same
   output, and its time and bound at phase 2's widest k;
6. the statistics chain at k = 4 on the same corpus, in a temporary working
   directory: ``find_dist`` (a 100,000-value background sample),
   ``fit_distributions`` (norm, expon, rayleigh, uniform), ``find_pval`` for
   the first 1,000 transcripts against all 13,000 (empirical and fitted) and
   for the first 2,048 against themselves, ``adj_pval(fdr_bh)`` on each,
   ``pearson_pairs`` on 100,000 random pairs, and the six CLI commands in
   process on the first 1,000 transcripts.  Checked: r within 1e-4 of a
   float64 recomputation; empirical p-values equal to the float64 ECDF away
   from background ties (the share of near-tie cells is printed); fitted ones
   within 1e-4 of scipy's cdf; the self matrix exactly symmetric and corrected
   on its upper triangle; adj_pval within 1e-12 of a direct float64
   Benjamini-Hochberg; pearson_pairs within 1e-5 of the blocked r-matrix.  One
   JSON line per step gives its wall time and the device time (CUDA events) of
   its counts and its GEMM; a breakdown times each host part twice, through the
   host C++ library and through the Python/numpy path it replaced
   (``SEEKR_TPU_HOST_SORT=numpy``, the Python parse and writer), times the
   ECDF at the benchmark's pval sizes (all 84.5 M pairs' r as the null, 500
   query rows) on the host and on the card, and fails unless the counts, the
   corrections, the 13 M-cell CSV bytes and the two ECDFs' p-values agree;
7. the warm-resident service (``serve.SeekrService``) at seekr_tpu's serving
   benchmark size (``bench.py:410-475``): the corpus as 13,000 targets at k = 6,
   Log2.post, the width padded to 13,056 rows, the norm vectors and a
   100,000-value empirical background from ``find_dist``.  Recorded: load and
   warmup time; interleaved rounds of Q=1 ``sim`` and Q=128 ``topk=10``
   queries of 512-2,048 bases (the Q=1 p50 and the Q=128 sequences/s); a burst
   of 16 threads x 8 queries (device batches, latency percentiles); growth
   within and across the width quantum; a snapshot saved and loaded; a round
   trip over a UNIX socket; the device ms of each stage of a Q=1 and a Q=128
   pass.  Checked: sim within 1e-4 of float64; top-k equal to a stable sort of
   sim; empirical p-values equal to ``SortedBackground``; the segmented
   normalize bitwise equal to ``normalize_counts`` per request; the burst
   within 1e-6 of the serial answers; existing scores bitwise across a grow
   within the quantum and after a snapshot reload; socket answers equal to
   in-process ones;
8. communities (``graph.kmer_leiden``) at the reference's background size:
   13,000 k = 6 transcripts in 260 planted families of 50 (each member its
   founder with 10% of its bases substituted), norm vectors from the corpus,
   ``RBERVertexPartition``, ``setseed``, cutoff 0.2; dense, streamed with its
   Gephi export, and the dense export on the first 500.  Printed: the within-
   and across-family r quantiles and each stage's time (counter, GEMM, copy,
   threshold, edges, Leiden, export, the card's busy share).  Checked: the
   similarity within 1e-4 of float64; the edge set equal to float64's but for
   pairs within 1e-4 of the cutoff; the 260 families found exactly; two seeded
   runs identical; the streamed edges and partition equal to the dense ones;
9. the one-shot workflow and the tools around it, at k = 6 in a temporary
   working directory.  ``run_workflow`` with phase 3's corpus as the background
   (a 100,000-value null) on the first 2,600 of phase 8's family transcripts
   with the Leiden stage (cutoff 0.2), and the CLI's ``pipeline`` for the first
   1,000 transcripts against all 13,000: each ``stage_timer`` stage, the count
   and GEMM device ms, peak device memory; held to the port's stepwise chain
   (norm vectors, counts within 1e-5, r within 1e-4 of float64, p-values equal
   away from null ties, adjusted within 1e-12 of a direct BH, the null the
   seeded draw of float64 r, the 52 families exactly, every artifact present).
   Then ``find_pval --stream -bo`` for 13,000 x 13,000 and 1,000 x 13,000,
   and ``adj_pval_stream`` on each, in a process of its own beside the
   in-memory ``adj_pval`` (fdr_bh; on the cross matrix also bonferroni, holm,
   fdr_by; and fdr_bh on its first 50 rows with ``max_bucket_pairs`` 2,000,
   which forces the tie-mass segments): each pass's wall s, scratch bytes and
   peak resident set, the .npy bitwise and the CSV byte-equal.  ``DomainPearson`` (8 queries, 1,000
   targets in windows of 1,000 every 100, the corpus as reference): r within
   1e-4 of a float64 recomputation from ``count_torch``'s counts, percentiles
   equal away from ties, the window labels.  ``CountsWeighter`` on the
   corpus' k = 5 counts with 64 seeded PWMs and the repo's fixture PWM, within
   1e-9 relative of ``counts @ weights`` built apart.  The data tools on the
   corpus with GENCODE-style headers and a seeded GTF: ``canonical_gencode``
   and ``filter_gencode`` against a direct filter, ``gen_rand_rnas -k 2`` on
   1,000 transcripts with every 2-mer count kept, bitwise.  ``doctor`` in a
   subprocess exits 0 and names the card;
10. the plots' and graphs' compute, at the reference's background size.  The
   dendrogram's path on the k = 6 Log2.post profiles of phase 8's 13,000 family
   transcripts (counted on the card), rows [13,000 x 4,096] and columns: the
   device pdist (routed there by ``use_device_pdist``), ``linkage`` (complete)
   and the leaf order, with each step timed (the Gram product and the distance
   epilogue by CUDA events, the copy, ``triu_values``, ``linkage``,
   ``leaves_list``).  Checked: every row distance within 1e-5 of a float64
   pdist on the card, NaN where NaN (the column distances, each a sum over
   13,000 values, within seekr_tpu's budget against scipy, rtol 1e-4 / atol
   1e-5; both errors' maximum and 99.9th percentile are printed); the first
   1,000 rows within rtol 1e-4 / atol
   1e-5 of scipy's pdist, and their leaf order equal to float64's unless two
   float64 merge heights lie within 1e-5 (then the share of equal leaves is
   printed); the adjusted Rand index of 260 clusters against the planted
   families is printed.  The heatmap's row and column orders of phase 3's
   4,096 x 4,096 self-Pearson block, its pdist held to float64 likewise.  The
   barplots' counts of phase 3's corpus (on the card, within 1e-5 of float64)
   and their orders (count: the first 10 transcripts; mean and sd: all
   13,000), equal to float64's away from 1e-5 ties.  The textplots' word
   coordinates of 10 words on phase 4's two long transcripts, equal to a
   window scan.  ``visualize_distro``'s streamed statistics of phase 3's
   matrix (mirrored, as an ``.npy``): n exact, mean and sd within 1e-9
   relative of float64, the median within one fine bin of the middle value,
   each pass and the symmetry probe timed.  ``help`` in a fresh process: 25
   sections.  The drawing entry points draw where matplotlib, seaborn and
   networkx are installed, and otherwise raise ``ModuleNotFoundError`` naming
   the missing one (the card's machine has none; the drawing is held to
   seekr_tpu on the CPU by ``tests/test_torch_viz.py`` and its neighbours);
11. the device mesh in one process (``seekr_tpu_torch.parallel``) over every
   visible card, or four shards of the one card (``[cuda:0] * 4``: every line
   of the sharded code and its kernels, but no copy between cards, so no
   measure of scaling).  ``distributed_pipeline`` on phase 3's corpus at k = 6
   (the median of 5 beside the single path's forward in the same call, and the
   count kernel's device ms on one shard), ``flat=False`` and the norm-vector
   mode once each; ``distributed_norm_stats``; a (2, 2) grid at k = 9 on 2,048
   rows (``count_kmers_hiblocked`` per data shard, 2.1 GB of counts);
   ``count_long_sequence`` on one 4 Mb transcript; ``stream_pearson_sharded``
   on the 13,000^2 self matrix and 1,000 x 13,000; ``find_dist`` (phase 6's
   seeded draw, k = 4), ``find_pval`` (cross and self) and ``kmer_leiden`` (the
   first 2,600 of phase 8's family transcripts) with ``data_parallel`` (below
   two cards it resolves to the shards of the one card, through
   ``data_parallel_on_shards``); the CLI's ``find_dist -dp`` (on one card it
   must fail with seekr_tpu's "requested 4 devices ... have 1"); the service
   with ``mesh=`` on phase 7's targets (Q=1 ``sim`` and Q=128 ``topk=10``
   interleaved with the single-card service, growth within and across the
   width quantum, a snapshot); a checkpoint of the sharded 13,000 x 4,096
   counts restored onto the (2, 2) grid.  Checked: counts per shard bitwise;
   normalized counts, mean and std within rtol 1e-4 / atol 1e-5 and r within
   1e-4 of the single device; at k = 9, the grid's r and the single path's
   within 1e-4 of float64 (the single path as one cuBLAS product, as before
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
   at k = 6, median of 5 in each process with its collectives' host ms apart,
   beside the one-process mesh of the same two positions timed here; each
   process holds its shards against its own one-process mesh of the same grid
   (counts, mean, std bitwise, r within 1e-6) and ``SeekrPipeline.forward``
   (1e-4).  (b) The CLI's ``serve -dp 2 --num_processes 2 --coordinator`` on
   phase 7's 13,000 targets: interleaved Q=1 ``sim`` and Q=128 ``topk=10``
   socket requests beside the single-card service behind a socket of its own
   (sim within 1e-6, top-k equal away from near ties), one ``add_targets``, a
   shutdown after which both processes exit 0.  (c) A pod whose follower is
   killed: the client's "unresponsive" error within the watchdog's 10 s and a
   margin, later requests failing at once, the leader exiting 0.  (d) The CLI's
   ``pipeline -dp 2 --num_processes 2`` (1,000 queries, a 2,048-transcript
   background): only process 0 writes, its artifacts byte-equal to one process
   holding the same mesh, the counts and norm vectors to the single card, r
   within 1e-5 of it.

Launch counts are set to 0 just before phases 3, 4, 6, 7, 8, 9 (the workflow,
``domain_pearson`` and the PWM counts), 10 (the profiles and the barplots'
counts) and each main-path section of phase 11 drive the main path and read just
after; in phase 12 each child process counts from 0 over its main path and
prints its counts on its JSON line, which are added to the main path's.  The
run fails if a kernel of the path was not launched, phases 9 and 10
fail if their counting did not launch ``count_kmers_smem``, phase 11 if its
pipeline did not launch ``count_kmers_smem`` on every shard or its k = 9 grid
``count_kmers_hiblocked`` on every data shard, and phase 12 if the processes of
(a), (b) or (d) did not launch ``count_kmers_smem``.
The last lines are the ``kernels`` JSON line, the card's ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import re
import statistics
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
    reps: int            # timed repetitions
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
    mesh_reps: int       # timed repetitions of the mesh pipeline


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
    """The host paths as they ran before the C++ library, for a "before" reading
    and as the reference of the native ones: the Python FASTA parse and encode
    (the native parse gate answers no) and the numpy sorts
    (``SEEKR_TPU_HOST_SORT=numpy``).
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

    t0 = time.perf_counter()
    state["native_library"] = native.library_path()  # g++ at first use: no fallback
    state["native_build_s"] = time.perf_counter() - t0
    log(f"host library (g++): {state['native_library']}, build + load "
        f"{state['native_build_s']:.2f} s")
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
    t0 = time.perf_counter()
    build.load_library()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
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


def read_launches(state, phase):
    """Add the launches made since the last reset to the main-path counts."""
    from seekr_tpu_torch.ops import count_cuda

    main = state.setdefault("launches", dict.fromkeys(count_cuda.KERNELS, 0))
    for name, n in count_cuda.launches.items():
        main[name] += n
    log(f"{phase}: kernel launches {dict(count_cuda.launches)}")


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


def gemm_kernels(fn) -> dict:
    """{name: launches} of the GEMM kernels one call of ``fn`` runs on the card
    (``torch.profiler``; names cut to 100 characters)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                re.search(r"(?i)gemm|xmma|cutlass", ev.name):
            names[ev.name[:100]] = names.get(ev.name[:100], 0) + 1
    return names


def phase_pipeline(device, scale, state):
    """Main path, pipeline entry: SeekrPipeline(k=6, Log2.post).forward."""
    import torch

    from seekr_tpu_torch.models.pipeline import SeekrPipeline
    from seekr_tpu_torch.ops import count_cuda
    from seekr_tpu_torch.ops import pearson as pearson_ops
    from seekr_tpu_torch.ops.count import count_graph
    from seekr_tpu_torch.ops.normalize import normalize_graph
    from seekr_tpu_torch.ops.pearson import _row_standardize, divide, matmul_nt, self_gram

    bases, lengths = make_corpus(scale.corpus_m, scale.corpus_cap, state["seed"])
    state["corpus"] = (bases, lengths)
    m = bases.shape[0]
    log(f"corpus: m={m}, Lpad={bases.shape[1]}, {int(lengths.sum())} bases, "
        f"median length {int(np.median(lengths))}")
    pipe = SeekrPipeline(k=PIPELINE_K, log2="Log2.post", device=device)
    bt = torch.as_tensor(bases, device=device)  # set-up: one upload of the corpus
    nt = torch.as_tensor(lengths, device=device)

    count_cuda.reset_launches()
    routes = dict(pearson_ops.gram_routes)
    for _ in range(3):
        sim = pipe.forward(bt, nt)
    sync(device)
    routes = sorted(k for k, v in pearson_ops.gram_routes.items() if v != routes[k])
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for _ in range(scale.reps):
        t0 = time.perf_counter()
        sim = pipe.forward(bt, nt)
        sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    read_launches(state, "pipeline")

    wall = statistics.median(walls)
    out = {"phase": "pipeline", "m": m, "k": PIPELINE_K, "forward_ms_median": wall,
           "forward_ms_all": walls, "transcripts_per_s": m / (wall / 1e3)}
    if is_cuda(device):
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
        raw = count_graph(bt, nt, PIPELINE_K)
        normalized, _, _ = normalize_graph(raw, None, None, "Log2.post")
        operand = _row_standardize(normalized)
        out["count_ms"] = cuda_ms(lambda: count_graph(bt, nt, PIPELINE_K), scale.reps)
        out["normalize_ms"] = cuda_ms(
            lambda: normalize_graph(raw, None, None, "Log2.post"), scale.reps)
        out["row_standardize_ms"] = cuda_ms(lambda: _row_standardize(normalized), scale.reps)
        # the float32 product (``highest``) beside the forward's self Gram
        # (``high``: the split TF32 product), each r held to float64
        n = operand.shape[1]
        out["pearson_gemm_ms"] = cuda_ms(lambda: matmul_nt(operand, operand), scale.reps)
        gemm_flop = 2.0 * m * m * n
        out["pearson_gemm_tflop_per_s"] = gemm_flop / (out["pearson_gemm_ms"] / 1e3) / 1e12
        out["self_gram_route"] = routes
        out["self_gram_ms"] = cuda_ms(lambda: self_gram(operand), scale.reps)
        out["self_gram_tflop_per_s"] = gemm_flop / (out["self_gram_ms"] / 1e3) / 1e12
        out["self_gram_kernels"] = gemm_kernels(lambda: self_gram(operand))
        exact = operand.to(torch.float64)
        exact = (exact @ exact.T) / n
        out["self_gram_r_max_abs_vs_f64"] = \
            (divide(self_gram(operand), n).to(torch.float64) - exact).abs().max().item()
        out["fp32_gemm_r_max_abs_vs_f64"] = \
            (matmul_nt(operand, operand).to(torch.float64) - exact).abs().max().item()
        del normalized, operand, exact
    else:
        raw = count_graph(bt, nt, PIPELINE_K)

    if sim.shape != (m, m) or not bool(torch.isfinite(sim).all()):
        raise AssertionError(f"pipeline output: shape {tuple(sim.shape)}, "
                             f"finite {bool(torch.isfinite(sim).all())}")
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
    from seekr_tpu_torch.ops import count_cuda
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

        count_cuda.reset_launches()
        t0 = time.perf_counter()
        counts = KmerCounter(str(fa), k=PIPELINE_K, silent=True, device=device).get_counts()
        t1 = time.perf_counter()
        sim = pearson(counts, counts, device=device)
        t2 = time.perf_counter()
        long_counts = KmerCounter(str(fa_long), k=PIPELINE_K, **raw).get_counts()
        large_k_counts = KmerCounter(str(fa_large_k), k=LARGE_K, **raw).get_counts()
        t3 = time.perf_counter()
        read_launches(state, "counter")
        # the Python parse and encode on the same file (not counted):
        # its time, and the native path's counts bit for bit
        with python_host_paths():
            t4 = time.perf_counter()
            python_counts = KmerCounter(str(fa), k=PIPELINE_K, silent=True,
                                        device=device).get_counts()
            t5 = time.perf_counter()

    m = len(seqs)
    out = {"phase": "counter", "m": m, "get_counts_s": t1 - t0, "pearson_s": t2 - t1,
           "long_and_large_k_s": t3 - t2, "get_counts_python_host_s": t5 - t4,
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
    state["kernels"] = rows


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


def count_device_ms(seqs, k, passes, device, reps):
    """Device time of the count kernel over a counter's buckets, ``passes``
    times (CUDA events); None on the CPU."""
    if not is_cuda(device):
        return None
    import torch

    from seekr_tpu_torch.io.encode import encode_seqs
    from seekr_tpu_torch.models.counter import _MAX_ROWS_PER_BUCKET
    from seekr_tpu_torch.ops.count_cuda import count_kmers_cuda

    total = 0.0
    for b, n, _ in encode_seqs(seqs, k, max_rows_per_bucket=_MAX_ROWS_PER_BUCKET).buckets:
        bt, nt = torch.as_tensor(b, device=device), torch.as_tensor(n, device=device)
        total += cuda_ms(lambda: count_kmers_cuda(bt, nt, k), reps)
    return passes * total


def gemm_device_ms(c1, c2, device, reps, block_rows=None):
    """Device time of the Pearson GEMM(s) on standardized operands (CUDA
    events), in row blocks as the streamed path runs it; None on the CPU."""
    if not is_cuda(device):
        return None
    from seekr_tpu_torch.ops.pearson import _row_standardize, matmul_nt

    a, b = _row_standardize(c1), _row_standardize(c2)
    rows = block_rows or a.shape[0]
    return sum(cuda_ms(lambda s=s: matmul_nt(a[s:s + rows], b), reps)
               for s in range(0, a.shape[0], rows))


class _Discard:
    """A stream_pearson writer that drops its blocks (after their copy to the host)."""

    def append(self, block):
        pass


def stats_breakdown(device, scale, state, seqs, bkg, fitres, p_emp):
    """Where the time of find_dist, find_pval and adj_pval goes: their parts,
    each timed apart on the host clock (ending in a synchronize) after the
    main-path run, at the main path's sizes."""
    import os

    import torch

    from seekr_tpu_torch.io.encode import encode_fasta, encode_seqs
    from seekr_tpu_torch.io.fast_csv import (labeled_csv_bytes, read_labeled_csv,
                                             write_labeled_csv)
    from seekr_tpu_torch.io.fasta import Reader
    from seekr_tpu_torch.io.stream import stream_pearson
    from seekr_tpu_torch.models.counter import _MAX_ROWS_PER_BUCKET, KmerCounter
    from seekr_tpu_torch.models.pearson import pearson
    from seekr_tpu_torch.ops.ecdf import DeviceSortedBackground, SortedBackground
    from seekr_tpu_torch.stats import adj_pval
    from seekr_tpu_torch.stats.fast_cdf import fast_cdf
    from seekr_tpu_torch.stats.find_dist import similarity_triu
    from seekr_tpu_torch.stats.multitest import multipletests

    parts = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        sync(device)
        parts[name] = time.perf_counter() - t0
        return result

    # each host step twice where the native library took it over: native first,
    # then the Python/numpy path it replaced ("_python"), which must agree
    timed("fasta_parse_s", lambda: Reader("corpus.fa").get_seqs())
    timed("encode_s", lambda: encode_fasta("corpus.fa", STATS_K,
                                           max_rows_per_bucket=_MAX_ROWS_PER_BUCKET))
    counts = timed("counter_s", lambda: KmerCounter(
        "corpus.fa", k=STATS_K, silent=True, device=device).get_counts_device())
    with python_host_paths():
        timed("fasta_parse_python_s", lambda: Reader("corpus.fa").get_seqs())
        timed("encode_python_s", lambda: encode_seqs(
            seqs, STATS_K, max_rows_per_bucket=_MAX_ROWS_PER_BUCKET))
        python_counts = timed("counter_python_s", lambda: KmerCounter(
            "corpus.fa", k=STATS_K, silent=True, device=device).get_counts_device())
    if not torch.equal(counts, python_counts):
        raise AssertionError("phase 6 counts: the native parse and encode differ")
    del python_counts
    timed("blocked_gemm_and_copy_s", lambda: stream_pearson(counts, counts, _Discard(),
                                                            device=device))
    triu = timed("similarity_triu_s", lambda: similarity_triu(counts, device=device))
    np.random.seed(state["seed"])
    timed("random_choice_s", lambda: np.random.choice(
        triu, size=min(scale.stats_subset, len(triu)), replace=False))
    sim = timed("pearson_query_s", lambda: pearson(counts[:scale.stats_query], counts,
                                                   device=device))
    timed("ecdf_s", lambda: SortedBackground(bkg).pvals(sim))
    # the pval cell's ECDF at its sizes, every pair's r as the null against
    # 500 query rows: on the host, and on the device (find_pval's path on a
    # card), bitwise equal
    cell_r = sim[:PVAL_CELL_QUERIES]
    host_p = timed("ecdf_cell_host_s",
                   lambda: SortedBackground(triu).pvals(cell_r).astype(np.float32))
    device_p = timed("ecdf_cell_device_s", lambda: DeviceSortedBackground(triu, device).pvals(
        torch.as_tensor(cell_r, device=device)))
    parts["ecdf_cell_cells"], parts["ecdf_cell_null_values"] = int(cell_r.size), len(triu)
    parts["ecdf_cell_device_bitwise_host"] = device_p.tobytes() == host_p.tobytes()
    if not parts["ecdf_cell_device_bitwise_host"]:
        raise AssertionError("the device ECDF differs from the host's at the pval cell's sizes")
    del triu, host_p, device_p
    name, _, params = fitres[0]
    timed("fast_cdf_s", lambda: fast_cdf(name, params, sim))
    native_mt = timed("multipletests_s", lambda: multipletests(p_emp.values, method="fdr_bh"))
    native_adj = timed("adj_pval_s", lambda: adj_pval(p_emp, "fdr_bh").values)
    with python_host_paths():
        numpy_mt = timed("multipletests_python_s", lambda: multipletests(p_emp.values,
                                                                           method="fdr_bh"))
        numpy_adj = timed("adj_pval_python_s", lambda: adj_pval(p_emp, "fdr_bh").values)
    same = {"multipletests_bitwise_numpy": all(
                a.tobytes() == b.tobytes() for a, b in zip(native_mt[:2], numpy_mt[:2])),
            "adj_pval_bitwise_numpy": native_adj.tobytes() == numpy_adj.tobytes()}
    del native_mt, numpy_mt, native_adj, numpy_adj
    timed("write_pvals_csv_s", lambda: write_labeled_csv(
        "pvals.csv", p_emp.values, p_emp.index, p_emp.columns))
    timed("write_pvals_csv_python_s", lambda: Path("pvals_python.csv").write_bytes(
        labeled_csv_bytes(p_emp.values, p_emp.index, p_emp.columns)))
    same["pvals_csv_bytes_equal_python"] = (Path("pvals.csv").read_bytes()
                                            == Path("pvals_python.csv").read_bytes())
    os.unlink("pvals_python.csv")
    timed("read_pvals_csv_f32_s", lambda: read_labeled_csv("pvals.csv", dtype=np.float32))
    timed("read_pvals_csv_f64_python_s", lambda: read_labeled_csv("pvals.csv"))
    parts.update(same)
    failed = [name for name, ok in same.items() if not ok]
    if failed:
        raise AssertionError(f"native host paths differ from the Python ones: {failed}")
    if is_cuda(device):
        # the device's busy time inside whole calls, from a profiler trace
        from seekr_tpu_torch.stats import find_dist, find_pval

        for name, fn in (
                ("find_dist", lambda: find_dist("corpus.fa", k_mer=STATS_K,
                                                subset_size=scale.stats_subset,
                                                fit_model=False, device=device)),
                ("find_pval_empirical", lambda: find_pval(
                    "query.fa", "corpus.fa", f"bkg_mean_{STATS_K}mers.npy",
                    f"bkg_std_{STATS_K}mers.npy", STATS_K, bkg, device=device))):
            parts[f"{name}_profiled_wall_s"], parts[f"{name}_device_busy_s"] = \
                profiled_busy(device, fn)
    log(json.dumps({"phase": "stats", "breakdown": parts, "sim_cells": int(sim.size)}))
    return parts


def profiled_busy(device, fn):
    """(wall s, device busy s) of ``fn()`` under torch.profiler: the busy time
    is the sum of the device time of every kernel and copy in the trace (one
    stream, so nothing overlaps); None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    return wall, (busy_us / 1e6 if busy_us else None)


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
    steps, results = [], {}

    def step(name, fn):
        t0 = time.perf_counter()
        results[name] = fn()
        sync(device)
        steps.append({"phase": "stats", "step": name, "wall_s": time.perf_counter() - t0})

    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            write_fasta_file("corpus.fa", seqs)  # set-up: the files the user would have
            write_fasta_file("query.fa", seqs[:q])
            write_fasta_file("self.fa", seqs[:s])
            vectors = (f"bkg_mean_{STATS_K}mers.npy", f"bkg_std_{STATS_K}mers.npy")

            count_cuda.reset_launches()
            np.random.seed(state["seed"])
            step("find_dist", lambda: find_dist(
                "corpus.fa", k_mer=STATS_K, subsetting=True, subset_size=scale.stats_subset,
                fit_model=False, device=device))
            bkg = results["find_dist"]
            state["stats_background"] = bkg  # phase 11 draws it again on the mesh
            step("fit_distributions", lambda: fit_distributions(
                bkg, resolve_models(STATS_MODELS)))
            fitres = results["fit_distributions"]
            step("find_pval_empirical", lambda: find_pval(
                "query.fa", "corpus.fa", *vectors, STATS_K, bkg, device=device))
            step("find_pval_fitted", lambda: find_pval(
                "query.fa", "corpus.fa", *vectors, STATS_K, fitres, device=device))
            step("find_pval_self", lambda: find_pval(
                "self.fa", "self.fa", *vectors, STATS_K, fitres, device=device))
            for name in ("empirical", "fitted", "self"):
                step(f"adj_pval_{name}", lambda name=name: adj_pval(
                    results[f"find_pval_{name}"], "fdr_bh"))
            counts = KmerCounter("corpus.fa", mean=vectors[0], std=vectors[1], k=STATS_K,
                                 silent=True, device=device).get_counts_device()
            rng = np.random.default_rng(state["seed"] + 4)
            ii, jj = rng.integers(0, m, size=(2, scale.stats_pairs))
            step("pearson_pairs", lambda: pearson_pairs(counts, ii, jj, device=device))
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
                name = f"cli_{argv[0]}" + ("_fit" if "-fm" in argv else "")
                step(name, lambda argv=argv: cli.main(argv + ["--device", dev]))
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

            p_emp = results["find_pval_empirical"]
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
            out["fitted_max_abs_vs_scipy"] = float(np.abs(results["find_pval_fitted"].values
                                                          - want).max())
            if not out["fitted_max_abs_vs_scipy"] <= 1e-4:
                raise AssertionError(f"fitted p-values: {out['fitted_max_abs_vs_scipy']}")

            p_self = results["find_pval_self"]
            if not np.array_equal(p_self.values, p_self.values.T) or not is_symmetric(p_self):
                raise AssertionError("the self p-value matrix is not exactly symmetric")

            worst = 0.0
            for name in ("empirical", "fitted", "self"):
                pv, adj = results[f"find_pval_{name}"], results[f"adj_pval_{name}"]
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
            out["pairs_max_abs_vs_blocked"] = float(np.abs(results["pearson_pairs"]
                                                           - full[ii, jj]).max())
            del full
            if not out["pairs_max_abs_vs_blocked"] <= 1e-5:
                raise AssertionError(f"pearson_pairs: {out['pairs_max_abs_vs_blocked']}")

            cli_adj = read_labeled_csv("cli_adj.csv")
            if cli_adj.shape != (q, q) or not np.isnan(cli_adj.values[np.tril_indices(q)]).all():
                raise AssertionError(f"CLI adj_pval: shape {cli_adj.shape}")
            if read_labeled_csv("pearson.csv").shape != (q, q) \
                    or read_labeled_csv("counts.csv").shape != (q, 4 ** PIPELINE_K):
                raise AssertionError("CLI kmer_counts / pearson artifacts")

            # -- device time of the counts and of the GEMM, per step ----------
            device_ms = {
                "find_dist": (count_device_ms(seqs, STATS_K, 2, device, scale.reps),
                              gemm_device_ms(counts, counts, device, scale.reps, 4096)),
                "find_pval_empirical": (
                    count_device_ms(seqs[:q], STATS_K, 1, device, scale.reps)
                    + count_device_ms(seqs, STATS_K, 1, device, scale.reps)
                    if is_cuda(device) else None,
                    gemm_device_ms(c_query, counts, device, scale.reps)),
                "find_pval_self": (count_device_ms(seqs[:s], STATS_K, 1, device, scale.reps),
                                   gemm_device_ms(counts[:s], counts[:s], device,
                                                  scale.reps)),
            }
            device_ms["find_pval_fitted"] = device_ms["find_pval_empirical"]
            state["stats_breakdown"] = stats_breakdown(device, scale, state, seqs, bkg,
                                                       fitres, p_emp)
        finally:
            os.chdir(home)

    for row in steps:
        count_ms, gemm_ms = device_ms.get(row["step"], (None, None))
        row["count_device_ms"], row["gemm_device_ms"] = count_ms, gemm_ms
        if count_ms is not None:
            row["device_share"] = (count_ms + gemm_ms) / 1e3 / row["wall_s"]
        log(json.dumps(row))
    out["wall_s"] = sum(row["wall_s"] for row in steps)
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


def timed_queries(svc, batches, want, topk=SERVE_TOPK):
    """Host-clock ms of each ``svc.query`` (each returns its answer on the host)."""
    ms = []
    for batch in batches:
        t0 = time.perf_counter()
        svc.query(batch, want=want, topk=topk)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


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
        t0 = time.perf_counter()
        pong = request(path, {"op": "ping"}, timeout=60)
        answer = request(path, {"seqs": queries, "want": ["topk_pvals"],
                                "topk": SERVE_TOPK}, timeout=60)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        try:
            request(path, {"op": "shutdown"}, timeout=60)
        except OSError:
            pass
        server.join(timeout=60)
    if server.is_alive():
        raise AssertionError("the socket server did not stop")
    return pong, answer, ms


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


def serve_breakdown(svc, batch, want, reps, device):
    """Device ms of each stage of one serial pass (CUDA events): count (the
    kernel on the uploaded bucket), normalize, GEMM (the query's row
    standardization and the product), the top-k sort, and the copy to the host;
    beside it the host's counter set-up and encode, torch.topk on the same row
    (a yardstick with no tie order) and the pass's host-clock wall.  A stage of
    many small launches is timed at the rate the host issues them.  None on the
    CPU."""
    if not is_cuda(device):
        return None
    import torch

    from seekr_tpu_torch.io.encode import encode_seqs
    from seekr_tpu_torch.ops.count_cuda import count_kmers_cuda
    from seekr_tpu_torch.ops.normalize import normalize_counts
    from seekr_tpu_torch.serve import _topk

    q = len(batch)
    padded = svc._pad_batch(batch)
    t0 = time.perf_counter()
    counter = svc._seq_counter(padded)
    t1 = time.perf_counter()
    enc = encode_seqs(padded, SERVE_K, min_bucket_len=counter.min_bucket_len)
    t2 = time.perf_counter()
    (b, n, _), = enc.buckets
    bt, nt = torch.as_tensor(b, device=device), torch.as_tensor(n, device=device)
    raw = count_kmers_cuda(bt, nt, SERVE_K)[:len(padded)]  # the bucket's pad rows dropped
    qc, _, _ = normalize_counts(raw, log2_mode=svc.log2, mean=svc._mean_t, std=svc._std_t)
    sim = svc._sim_device(qc)
    n_run = 16  # the next power of two >= SERVE_TOPK
    vals, idx = _topk(sim, svc._n_targets, n_run, True)
    masked = sim.masked_fill(torch.arange(sim.shape[1], device=device) >= svc._n_targets,
                             float("-inf"))
    if "topk" in want:
        def d2h():
            vals[:q, :SERVE_TOPK].cpu(), idx[:q, :SERVE_TOPK].int().cpu()
    else:
        def d2h():
            sim[:q, :svc._n_targets].cpu()
    out = {
        "q": q, "padded_rows": len(padded), "bucket": list(b.shape), "want": list(want),
        "counter_setup_ms": (t1 - t0) * 1e3, "host_encode_ms": (t2 - t1) * 1e3,
        "count_ms": cuda_ms(lambda: count_kmers_cuda(bt, nt, SERVE_K), reps),
        "normalize_ms": cuda_ms(lambda: normalize_counts(
            raw, log2_mode=svc.log2, mean=svc._mean_t, std=svc._std_t), reps),
        "gemm_ms": cuda_ms(lambda: svc._sim_device(qc), reps),
        "d2h_ms": cuda_ms(d2h, reps),
        "wall_ms_median": statistics.median(timed_queries(svc, [batch] * reps, want)),
    }
    out["topk_sort_ms"] = cuda_ms(lambda: _topk(sim, svc._n_targets, n_run, True), reps) \
        if "topk" in want else None
    out["torch_topk_ms"] = cuda_ms(lambda: torch.topk(masked, n_run, dim=1), reps) \
        if "topk" in want else None
    device_ms = sum(out[key] or 0.0 for key in
                    ("count_ms", "normalize_ms", "gemm_ms", "topk_sort_ms", "d2h_ms"))
    out["device_ms"] = device_ms
    out["host_remainder_ms"] = out["wall_ms_median"] - device_ms
    out["gemm_tflop_per_s"] = 2.0 * len(padded) * sim.shape[1] * qc.shape[1] \
        / (out["gemm_ms"] / 1e3) / 1e12
    # the card's busy share of whole passes, from a profiler trace
    out["profiled_wall_s"], out["device_busy_s"] = profiled_busy(
        device, lambda: timed_queries(svc, [batch] * reps, want))
    return out


def phase_serve(device, scale, state):
    """The warm-resident service at the JAX benchmark's serving size
    (``bench.py:410-475``): the corpus as targets at k = 6, Log2.post, an
    empirical background from find_dist, interleaved Q=1 sim and Q=128 top-k
    rounds, a coalesced burst, growth, a snapshot and the socket."""
    import os

    import torch

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
            count_cuda.reset_launches()
            t0 = time.perf_counter()
            svc = SeekrService(*vectors, k=SERVE_K, targets="targets.fa", fitres=bkg,
                               grow_quantum=SERVE_QUANTUM, device=device)
            sync(device)
            out["load_s"] = time.perf_counter() - t0
            out["resident_rows"] = int(svc._targets_std.shape[0])
            out["resident_bytes"] = svc._targets_std.numel() * 4
            t0 = time.perf_counter()
            svc.warmup()
            out["warmup_s"] = time.perf_counter() - t0
            out["max_coalesce_rows"] = svc.max_coalesce_rows
            timed_queries(svc, q1_batches[:1], ("sim",))  # batch-shape warm, as bench.py
            timed_queries(svc, big_batches[:1], ("topk",))
            if is_cuda(device):
                torch.cuda.reset_peak_memory_stats(device)
            p50s, tputs, q1_ms, big_ms = [], [], [], []
            for r in range(rounds):  # interleaved, as bench.py
                lat = timed_queries(svc, q1_batches[1 + r * scale.serve_q1:
                                                    1 + (r + 1) * scale.serve_q1], ("sim",))
                p50s.append(sorted(lat)[len(lat) // 2])
                q1_ms += lat
                lat = timed_queries(svc, big_batches[1 + r * scale.serve_big:
                                                     1 + (r + 1) * scale.serve_big], ("topk",))
                tputs.append(scale.serve_big_q / (sorted(lat)[len(lat) // 2] / 1e3))
                big_ms += lat
            out["q1_sim_p50_ms"] = sorted(p50s)[len(p50s) // 2]
            out["q1_sim_ms_all"] = q1_ms
            out[f"q{scale.serve_big_q}_topk{SERVE_TOPK}_seqs_per_s"] = \
                sorted(tputs)[len(tputs) // 2]
            out[f"q{scale.serve_big_q}_topk_ms_all"] = big_ms
            if is_cuda(device):
                out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
            mixed = svc.query(big_batches[0], want=("sim", "pvals", "topk", "topk_pvals"),
                              topk=SERVE_TOPK)
            batches_before = svc.device_batches
            svc._latencies.clear()  # the burst's own latency distribution
            t0 = time.perf_counter()
            burst_answers = coalesced_burst(svc, burst)
            out["burst"] = {"threads": n_threads, "queries_each": each,
                            "requests": n_threads * each,
                            "device_batches": svc.device_batches - batches_before,
                            "wall_s": time.perf_counter() - t0,
                            "latency": svc.latency_stats()}
            read_launches(state, "serve: load, warmup, traffic, burst")
            launched = count_cuda.launches["count_kmers_smem"]

            # the serial answers of the burst (a comparison: not counted)
            svc.coalesce = False
            serial = [[svc.query(b, want=("topk",), topk=SERVE_TOPK + 1) for b in batches]
                      for batches in burst]
            svc.coalesce = True

            # -- the main path: growth, snapshot, socket --------------------
            count_cuda.reset_launches()
            before = svc.query(check_q)["sim"]
            resident = svc._targets_std
            t0 = time.perf_counter()
            svc.add_targets(grow_in)
            out["grow_within_s"] = time.perf_counter() - t0
            in_place = svc._targets_std is resident
            after = svc.query(check_q)["sim"]
            t0 = time.perf_counter()
            svc.add_targets(grow_across)
            out["grow_across_s"] = time.perf_counter() - t0
            out["resident_rows_after_growth"] = int(svc._targets_std.shape[0])
            grown = svc.query(check_q)["sim"]
            t0 = time.perf_counter()
            svc.save_corpus("corpus.npz")
            out["save_corpus_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = SeekrService(*vectors, k=SERVE_K, targets="corpus.npz", fitres=bkg,
                                  grow_quantum=SERVE_QUANTUM, device=device)
            sync(device)
            out["snapshot_load_s"] = time.perf_counter() - t0
            from_snapshot = loaded.query(check_q)["sim"]
            del loaded
            pong, answer, out["socket_round_trip_ms"] = socket_round_trip(svc, check_q)
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
            out["breakdown"] = [
                serve_breakdown(svc, q1_batches[1], ("sim",), scale.reps, device),
                serve_breakdown(svc, big_batches[1], ("topk",), scale.reps, device)]
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
        ("burst answered", out["burst"]["latency"]["count"] == n_threads * each),
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
    background size, dense and streamed, with its checks and a stage breakdown."""
    import importlib
    import os

    import torch

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
           "native_library": state["native_library"],
           "native_build_s": state["native_build_s"]}
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
            count_cuda.reset_launches()
            if is_cuda(device):
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            membership = leiden.kmer_leiden("families.fa", *vectors, k, **run)
            out["kmer_leiden_dense_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            streamed = leiden.kmer_leiden("families.fa", *vectors, k, stream=True,
                                          csvfile="streamed", **run)
            out["kmer_leiden_streamed_with_export_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            head = leiden.kmer_leiden("head.fa", *vectors, k, stream=False, csvfile="dense",
                                      **run)
            out["kmer_leiden_dense_export_head_s"] = time.perf_counter() - t0
            if is_cuda(device):
                out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
            read_launches(state, "leiden")
            if is_cuda(device) and count_cuda.launches["count_kmers_smem"] == 0:
                raise AssertionError("kmer_leiden never launched count_kmers_smem")

            # -- stage by stage (not counted) ----------------------------------
            stages = {}

            def timed(name, fn):
                t0 = time.perf_counter()
                result = fn()
                sync(device)
                stages[name] = time.perf_counter() - t0
                return result

            counter = KmerCounter("families.fa", mean=vectors[0], std=vectors[1], k=k,
                                  silent=True, device=device)
            counts = timed("counter_s", counter.get_counts_device)
            stages["count_device_ms"] = count_device_ms(seqs, k, 1, device, scale.reps)
            sim = timed("pearson_s", lambda: pearson(counts, counts, device=device))
            stages["gemm_device_ms"] = gemm_device_ms(counts, counts, device, 3, 4096)
            if is_cuda(device):
                square = torch.empty((m, m), device=device)
                sync(device)
                t0 = time.perf_counter()
                square.cpu()
                stages["d2h_ms"] = (time.perf_counter() - t0) * 1e3
                del square

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

            def threshold():
                sim[sim < LEIDEN_CUTOFF] = 0
                np.fill_diagonal(sim, 0)

            timed("threshold_s", threshold)
            src, dst = timed("edge_extraction_s", lambda: np.nonzero(np.triu(sim > 0, k=1)))
            w = sim[src, dst]
            again = timed("leiden_s", lambda: leiden._run_leiden(
                src, dst, w, m, "RBERVertexPartition", 1.0, True))
            names = [f"t{i}" for i in range(m)]
            timed("export_s", lambda: leiden.export_gephi_csv_edges(
                names, again, src, dst, w, "breakdown"))
            s_src, s_dst, _ = timed("streamed_edges_s", lambda: leiden.sparse_similarity_edges(
                counts, LEIDEN_CUTOFF, device=device))
            del sim
            if is_cuda(device):
                stages["profiled_wall_s"], stages["device_busy_s"] = profiled_busy(
                    device, lambda: leiden.kmer_leiden("families.fa", *vectors, k, **run))
                if stages["device_busy_s"] is not None:
                    stages["device_busy_share"] = (stages["device_busy_s"]
                                                   / stages["profiled_wall_s"])
            out["stages"] = stages

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


class _StageRows(logging.Handler):
    """Collects the (stage, seconds) of each ``stage_timer`` record."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.rows = []

    def emit(self, record):
        self.rows.append((str(record.args[0]), float(record.args[1])))


@contextmanager
def captured_stages():
    """The port's ``stage_timer`` records of the block, as a list of
    (stage, seconds), kept off the console."""
    from seekr_tpu_torch.utils.logging import TIMING, get_logger

    log_ = get_logger(TIMING)
    handler = _StageRows()
    level, propagate = log_.level, log_.propagate
    log_.addHandler(handler)
    log_.setLevel(logging.INFO)
    log_.propagate = False
    try:
        yield handler.rows
    finally:
        log_.removeHandler(handler)
        log_.setLevel(level)
        log_.propagate = propagate


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


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def resident_bytes():
    """This process's resident set (``/proc/self/statm``), or None where the
    platform does not report it."""
    import os

    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class PeakResident:
    """The peak of ``resident_bytes()`` over a block, sampled every 10 ms by a
    thread (``ru_maxrss`` is no use here: it can carry the parent's peak)."""

    def __enter__(self):
        import threading

        self.bytes, self._stop = resident_bytes(), threading.Event()

        def sample():
            while not self._stop.wait(0.01):
                now = resident_bytes()
                if now is not None:
                    self.bytes = max(self.bytes or 0, now)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        now = resident_bytes()
        if now is not None:
            self.bytes = max(self.bytes or 0, now)


def adj_case(spec: dict) -> dict:
    """One ``adj_pval -bi`` case, run in a fresh process so that its memory is
    its own: ``adj_pval_stream`` on the .npy, then the in-memory ``adj_pval`` on
    the same matrix (loading it included); each one's wall time and peak
    resident set; the stream's passes, scratch bytes and segments; and whether
    the two .npy results are bitwise equal and the two CSVs byte-equal."""
    import contextlib
    import hashlib
    import io
    import os
    import shutil

    sys.path.insert(0, spec["root"])
    from seekr_tpu_torch.io.fast_csv import LabeledMatrix
    from seekr_tpu_torch.stats.adj_pval import adj_pval
    from seekr_tpu_torch.stats.stream_adj import adj_pval_stream

    def sha(path):
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 24), b""):
                h.update(chunk)
        return h.hexdigest()

    from seekr_tpu_torch.stats import stream_adj

    prefix, method = spec["prefix"], spec["method"]
    scratch = f"{prefix}_scratch"
    os.makedirs(scratch)
    marks, segments = [], []
    segment_plan = stream_adj._bucket_segments

    def counted_segments(*args):
        segs = segment_plan(*args)
        segments.append((len(segs), sum(seg.equal for seg in segs)))
        return segs

    stream_adj._bucket_segments = counted_segments
    out = {"method": method, "max_bucket_pairs": spec.get("max_bucket_pairs"),
           "baseline_rss_bytes": resident_bytes()}
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said), PeakResident() as peak:
        adj_pval_stream(spec["npy"], method, outputname=f"{prefix}_st",
                        out_npy=f"{prefix}_st.npy", scratch_dir=scratch,
                        max_bucket_pairs=spec.get("max_bucket_pairs"),
                        progress=lambda stage: marks.append(
                            (stage, time.perf_counter(), dir_bytes(scratch))))
    t1 = time.perf_counter()
    out["stream_wall_s"] = t1 - t0
    out["stream_peak_rss_bytes"] = peak.bytes
    out["stream_symmetric"] = "is a symmetric matrix" in said.getvalue()
    ends = [t for _, t, _ in marks[1:]] + [t1]
    out["stream_passes_s"] = {stage: end - t for (stage, t, _), end in zip(marks, ends)}
    out["scratch_bytes_at"] = {stage: b for stage, _, b in marks}
    out["value_buckets"] = len(segments)
    out["segments"] = sum(n for n, _ in segments)
    out["all_equal_segments"] = sum(e for _, e in segments)
    shutil.rmtree(scratch)

    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said), PeakResident() as peak:
        values = np.load(spec["npy"])
        m1, m2 = values.shape
        adj = adj_pval(LabeledMatrix(values, [str(i) for i in range(m1)],
                                     [str(j) for j in range(m2)]),
                       method, outputname=f"{prefix}_mem")
    out["memory_wall_s"] = time.perf_counter() - t0
    out["memory_peak_rss_bytes"] = peak.bytes
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
            count_cuda.reset_launches()
            if is_cuda(device):
                torch.cuda.reset_peak_memory_stats(device)
            with captured_stages() as stages:
                t0 = time.perf_counter()
                res = run_workflow("families.fa", background="corpus.fa", k=k,
                                   subset_size=scale.stats_subset, seed=seed, leiden=True,
                                   leiden_cutoff=WF_CUTOFF, outdir="self", device=device)
                sync(device)
                out["pipeline_self_s"] = time.perf_counter() - t0
                out["pipeline_self_stages_s"] = dict(stages)
                stages.clear()
                t0 = time.perf_counter()
                cli.main(["pipeline", "query.fa", "-s2", "corpus.fa", "-b", "corpus.fa",
                          "-k", str(k), "-sbs", str(scale.stats_subset), "-sd", str(seed),
                          "-o", "cross", "--device", dev])
                sync(device)
                out["pipeline_cross_cli_s"] = time.perf_counter() - t0
                out["pipeline_cross_stages_s"] = dict(stages)
            if is_cuda(device):
                out["pipeline_max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
                    device)
            workflow_launches = count_cuda.launches["count_kmers_smem"]
            read_launches(state, "workflow")
            out["pipeline_smem_launches"] = workflow_launches
            if is_cuda(device) and workflow_launches == 0:
                raise AssertionError("the workflow never launched count_kmers_smem")
            out["count_device_ms"] = {
                "background": count_device_ms(seqs, k, 1, device, scale.reps),
                "self_queries": count_device_ms(fam_seqs, k, 1, device, scale.reps),
                "cross_queries": count_device_ms(seqs[:q], k, 1, device, scale.reps)}

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
            gemm = {"background": gemm_device_ms(bkg_post, bkg_post, device, 3, 4096)}

            runs = {"self": ("families.fa", None, fam_seqs), "cross": ("query.fa", "corpus.fa",
                                                                       seqs[:q])}
            for name, (fa1, fa2, _) in runs.items():
                c1 = KmerCounter(fa1, k=k, mean=mean, std=std, silent=True,
                                 device=device).get_counts_device()
                c2 = c1 if fa2 is None else bkg_post
                gemm[name] = gemm_device_ms(c1, c2, device, 3, 4096 if fa2 is None else None)
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
            out["gemm_device_ms"] = gemm
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
            t0 = time.perf_counter()
            find_pval("corpus.fa", "corpus.fa", *vectors, k, null, stream=True,
                      npy_out="self_p.npy", device=device)
            find_pval("query.fa", "corpus.fa", *vectors, k, null, stream=True,
                      npy_out="cross_p.npy", device=device)
            out["find_pval_stream_s"] = time.perf_counter() - t0
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
            count_cuda.reset_launches()
            t0 = time.perf_counter()
            dom = DomainPearson("dom_q.fa", "dom_t.fa", "corpus.fa", r_values_path="r.csv",
                                percentiles_path="pct.csv", k=k, window=window, slide=slide,
                                device=device)
            dom.run()
            sync(device)
            out["domain_s"] = time.perf_counter() - t0
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
            out["domain_count_device_ms"] = (
                count_device_ms([w for _, _, w in windows], k, 1, device, scale.reps)
                + count_device_ms(seqs, k, 1, device, scale.reps)
                if is_cuda(device) else None)
            out["domain_gemm_device_ms"] = (
                gemm_device_ms(w_n.to(torch.float32), q_n.to(torch.float32), device, 3)
                + gemm_device_ms(q_n.to(torch.float32), ref_n.to(torch.float32), device, 3)
                if is_cuda(device) else None)
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
            count_cuda.reset_launches()
            t0 = time.perf_counter()
            pwm_counts = KmerCounter("corpus.fa", k=scale.pwm_k, silent=True,
                                     device=device).get_counts()
            scores = CountsWeighter("pwms", pwm_counts, k=scale.pwm_k,
                                    out_path="pwm_scores.csv").run()
            out["pwms_s"] = time.perf_counter() - t0
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
            t0 = time.perf_counter()
            cli.main(["canonical_gencode", "gencode.fa", "canonical.fa", "--device", dev])
            cli.main(["filter_gencode", "gencode.fa", "-gtf", "gencode.gtf", "-len",
                      str(DATA_LEN_THRESHOLD), "-can", "-iso", DATA_ISOFORM, "-o", "filtered",
                      "--device", dev])
            out["data_filters_s"] = time.perf_counter() - t0
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
            t0 = time.perf_counter()
            cli.main(["gen_rand_rnas", "rand_in.fa", "rand_out.fa", "-k", "2", "-s", str(seed),
                      "--device", dev])
            out["gen_rand_rnas_s"] = time.perf_counter() - t0
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
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=600)
            out["doctor_s"] = time.perf_counter() - t0
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
    from scipy.cluster.hierarchy import fcluster, leaves_list, linkage
    from scipy.spatial.distance import pdist

    from seekr_tpu_torch import cli
    from seekr_tpu_torch.io.fast_csv import LabeledMatrix
    from seekr_tpu_torch.models.counter import KmerCounter
    from seekr_tpu_torch.models.pearson import mirror_upper_inplace
    from seekr_tpu_torch.ops import count_cuda
    from seekr_tpu_torch.ops.dist import distance_matrix, pdist_device
    from seekr_tpu_torch.ops.precision import pearson_precision
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
            count_cuda.reset_launches()
            if is_cuda(device):
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            counter = KmerCounter("families.fa", k=k, silent=True, device=device)
            profiles = counter.get_counts()
            out["profiles_s"] = time.perf_counter() - t0
            labeled = LabeledMatrix(profiles, [h[1:] for h in counter.headers], counter.kmers)
            with pdist_route(m, n) as forced:
                out["pdist_forced_to_device"] = forced
                t0 = time.perf_counter()
                z_row, _, n_leaves = _dendrogram_linkage(labeled, "row", PLOT_METRIC,
                                                         PLOT_METHOD, device)
                out["dendrogram_row_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                z_col, _, _ = _dendrogram_linkage(labeled, "column", PLOT_METRIC,
                                                  PLOT_METHOD, device)
                out["dendrogram_column_s"] = time.perf_counter() - t0
            hm = min(scale.heatmap_rows, state["sim"].shape[0])
            block = np.ascontiguousarray(state["sim"][:hm, :hm])
            with pdist_route(hm, hm) as forced:
                out["heatmap_pdist_forced_to_device"] = forced
                t0 = time.perf_counter()
                _, row_order, _, col_order = _cluster_orders(block, PLOT_METRIC, PLOT_METHOD,
                                                             device)
                out["heatmap_orders_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            headers, counts, kmers = long_form.counted_profiles(
                "corpus.fa", "mean.npy", "std.npy", k, "Log2.post", device)
            count_rows = _barplot_rows(headers, counts, kmers, "ascending", 10)
            mean_rows = _msd_rows(headers, counts, kmers, "mean", "descending", 10)
            sd_rows = _msd_rows(headers, counts, kmers, "sd", "ascending", 10)
            out["barplots_s"] = time.perf_counter() - t0
            if is_cuda(device):
                out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
            smem = count_cuda.launches["count_kmers_smem"]
            read_launches(state, "plots")
            out["smem_launches"] = smem
            if is_cuda(device) and smem == 0:
                raise AssertionError("the plots' counting never launched count_kmers_smem")

            # -- the dendrogram's pdist, step by step (not counted) ---------------
            x = torch.as_tensor(profiles, device=device)
            stages = {}
            if is_cuda(device):
                def gram():
                    with pearson_precision():
                        return x @ x.T
                stages["gram_product_ms"] = cuda_ms(gram, 3)
                stages["distance_matrix_ms"] = cuda_ms(
                    lambda: distance_matrix(x, PLOT_METRIC), 3)
            full = distance_matrix(x, PLOT_METRIC)
            sync(device)
            t0 = time.perf_counter()
            full = full.cpu().numpy()
            stages["device_to_host_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            d_row = triu_values(full.astype(np.float64))
            stages["triu_values_s"] = time.perf_counter() - t0
            del full
            t0 = time.perf_counter()
            z_again = linkage(d_row, PLOT_METHOD)
            stages["linkage_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            leaves_list(z_again)
            stages["leaves_list_s"] = time.perf_counter() - t0
            if is_cuda(device):
                with pdist_route(m, n):
                    stages["profiled_wall_s"], stages["device_busy_s"] = profiled_busy(
                        device, lambda: _dendrogram_linkage(labeled, "row", PLOT_METRIC,
                                                            PLOT_METHOD, device))
                if stages["device_busy_s"] is not None:
                    stages["device_busy_share"] = (stages["device_busy_s"]
                                                   / stages["profiled_wall_s"])
            out["row_stages"] = stages
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
            t0 = time.perf_counter()
            d_scipy = pdist(head.astype(np.float64), PLOT_METRIC)
            out["scipy_pdist_head_s"] = time.perf_counter() - t0
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
            t0 = time.perf_counter()
            coords = [[find_word_coordinates(s, w).tolist() for w in words]
                      for s in state["long_pair"]]
            out["word_coordinates_s"] = time.perf_counter() - t0
            out["word_positions"] = [sum(len(c) for c in cs) for cs in coords]
            checks["word coordinates equal to a window scan"] = all(
                c == word_scan(s, w) for s, cs in zip(state["long_pair"], coords)
                for w, c in zip(words, cs))

            # -- visualize_distro's streamed statistics ------------------------------
            sim = state["sim"].copy()
            mirror_upper_inplace(sim)
            np.save("sim.npy", sim)
            del sim
            with captured_stages() as rows:
                t0 = time.perf_counter()
                counts_h, edges, n_vals, mean, sd, median = stream_distro_stats("sim.npy")
                out["distro_stream_s"] = time.perf_counter() - t0
            out["distro_stages_s"] = dict(rows)
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
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "seekr_tpu_torch.cli", "help"],
                                  cwd=here, capture_output=True, text=True, timeout=600)
            out["help_s"] = time.perf_counter() - t0
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

    count_cuda.reset_launches()
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
    checks, walls = {}, {}
    seed, dev = state["seed"], str(device)

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        sync_all(devices)
        walls[name] = time.perf_counter() - t0
        return result

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
        got = step(bt, nt)
        sync_all(devices)
        mesh_ms = []
        for _ in range(scale.mesh_reps):
            t0 = time.perf_counter()
            got = step(bt, nt)
            sync_all(devices)
            mesh_ms.append((time.perf_counter() - t0) * 1e3)
        parts = dist._sharded_count(mesh, bt, nt, PIPELINE_K)
        three = dist.distributed_pipeline(mesh, k=PIPELINE_K, flat=False)(bt, nt)
        vec = dist.distributed_pipeline(mesh, k=PIPELINE_K, use_norm_vectors=True)(
            bt, nt, ref_mean, ref_std)
        stats = dist.distributed_norm_stats(mesh, k=PIPELINE_K)(bt, nt)
        sync_all(devices)
    single_ms = []
    for _ in range(scale.mesh_reps):  # the single path in the same call, for scale
        t0 = time.perf_counter()
        pipe.forward(bt, nt)
        sync(device)
        single_ms.append((time.perf_counter() - t0) * 1e3)
    out.update(rows=m, k=PIPELINE_K, pipeline_ms_median=statistics.median(mesh_ms),
               pipeline_ms_all=mesh_ms, single_forward_ms_median=statistics.median(single_ms),
               pipeline_launches=dict(launched))
    checks["pipeline launched count_kmers_smem per shard"] = (
        not is_cuda(device) or launched["count_kmers_smem"] >= n * (scale.mesh_reps + 1))
    whole = count_graph(bt, nt, PIPELINE_K)
    m_loc = m // n
    checks["counts per shard bitwise"] = all(
        torch.equal(part.to(device), whole[i * m_loc:(i + 1) * m_loc])
        for i, part in enumerate(parts))
    if is_cuda(device):
        b0, n0 = bt[:m_loc].contiguous(), nt[:m_loc].contiguous()
        out["count_ms_per_shard"] = cuda_ms(lambda: count_graph(b0, n0, PIPELINE_K),
                                            scale.reps)
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
        kgot = timed("kmer_axis_pipeline_s", lambda: dist.distributed_pipeline(
            grid, k=LARGE_K, log2="Log2.none", use_norm_vectors=True)(kbt, knt, kmean, kstd))
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
        long_got = timed("long_sequence_s", lambda: dist.count_long_sequence(
            mesh, PIPELINE_K)(chunks, np.float32(n_windows)))
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
    timed("stream_pearson_single_s", lambda: stream_pearson(
        normalized, normalized, _RowFiller(full), device=device))
    filler = _RowFiller(sharded)  # the same writer as the single run's
    with counted(state, "mesh: stream_pearson_sharded"):
        timed("stream_pearson_sharded_s", lambda: dist.stream_pearson_sharded(
            mesh, normalized, filler))
    out["stream_self_max_abs"] = float(np.abs(sharded - full).max())
    checks["streamed self within 1e-4"] = filler.row == m and \
        out["stream_self_max_abs"] <= 1e-4
    del sharded
    cross = _TileDiff(full[:q])
    with counted(state, "mesh: stream_pearson_sharded cross"):
        timed("stream_pearson_sharded_cross_s", lambda: dist.stream_pearson_sharded(
            mesh, normalized[:q], cross, counts2=normalized))
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
                bkg = timed("find_dist_s", lambda: find_dist(
                    "corpus.fa", k_mer=STATS_K, subset_size=scale.stats_subset,
                    fit_model=False, data_parallel=n, device=device))
                fitres = [("norm", 0.0, (float(bkg.mean()), float(bkg.std())))]
                p_mesh = timed("find_pval_cross_s", lambda: find_pval(
                    "query.fa", "corpus.fa", *vectors, STATS_K, fitres, data_parallel=n,
                    device=device))
                p_self = timed("find_pval_self_s", lambda: find_pval(
                    "self.fa", "self.fa", *vectors, STATS_K, fitres, data_parallel=n,
                    device=device))
            err = float(np.abs(bkg - state["stats_background"]).max())
            out["find_dist_max_abs_vs_phase_6"] = err
            checks["find_dist within 1e-5 of phase 6's single-card draw"] = (
                bkg.shape == state["stats_background"].shape and err <= 1e-5)
            p_one = timed("find_pval_cross_single_s", lambda: find_pval(
                "query.fa", "corpus.fa", *vectors, STATS_K, fitres, device=device))
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
                members = timed("kmer_leiden_s", lambda: leiden.kmer_leiden(
                    *run, pearsoncutoff=LEIDEN_CUTOFF, setseed=True, data_parallel=n,
                    device=device))
            alone = timed("kmer_leiden_single_s", lambda: leiden.kmer_leiden(
                *run, pearsoncutoff=LEIDEN_CUTOFF, setseed=True, stream=True, device=device))
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
                svc = timed("serve_load_s", lambda: SeekrService(
                    *svec, k=SERVE_K, targets="targets.fa", grow_quantum=SERVE_QUANTUM,
                    mesh=mesh, device=device))
                rows_at_load = svc._resident_rows()
                timed("serve_warmup_s", svc.warmup)
                lat = {"mesh_q1": [], "single_q1": [], "mesh_big": [], "single_big": []}
                for r in range(scale.serve_rounds):  # interleaved, single card beside
                    for name, batches, want in (
                            ("q1", q1[r * scale.serve_q1:(r + 1) * scale.serve_q1], ("sim",)),
                            ("big", big[r * scale.serve_big:(r + 1) * scale.serve_big],
                             ("topk",))):
                        lat[f"mesh_{name}"] += timed_queries(svc, batches, want)
                        lat[f"single_{name}"] += timed_queries(one, batches, want)
                sims = [(svc.query(b)["sim"], one.query(b)["sim"]) for b in q1]
                tops = [(svc.query(b, want=("topk",), topk=SERVE_TOPK),
                         one.query(b, want=("topk",), topk=SERVE_TOPK + 1)) for b in big]
                before = svc.query(check_q)["sim"]
                timed("serve_grow_within_s", lambda: svc.add_targets(grow_in))
                within = svc.query(check_q)["sim"]
                timed("serve_grow_across_s", lambda: svc.add_targets(grow_across))
                grown = svc.query(check_q)["sim"]
                rows_after = svc._resident_rows()
                timed("serve_save_corpus_s", lambda: svc.save_corpus("mesh.npz"))
                loaded = timed("serve_snapshot_load_s", lambda: SeekrService(
                    *svec, k=SERVE_K, targets="mesh.npz", grow_quantum=SERVE_QUANTUM,
                    mesh=mesh, device=device))
                reloaded = loaded.query(check_q)["sim"]
            for name, ms in lat.items():
                out[f"serve_{name}_ms_median"] = statistics.median(ms)
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
                timed("checkpoint_save_s", lambda: save_sharded("ckpt", sharded_counts))
                back = timed("checkpoint_load_s", lambda: load_sharded(
                    "ckpt", sharding=row_col_sharding(grid)))
            checks["checkpoint round trip bitwise onto the (2, 2) grid"] = bool(torch.equal(
                back.gather(device), sharded_counts.gather(device)))
            out["checkpoint_bytes"] = m * 4 ** PIPELINE_K * 4
        finally:
            os.chdir(home)

    out["walls_s"] = walls
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
    deadline = time.perf_counter() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
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

    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
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
    count_cuda.reset_launches()
    got = step(bt, nt)
    sync(dev)
    walls, collective = [], []
    for _ in range(scale.mesh_reps):
        comm.reset_stats()
        t0 = time.perf_counter()
        got = step(bt, nt)
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        collective.append({name: dict(row) for name, row in comm.stats.items()})
    launches = dict(count_cuda.launches)

    # comparisons, not counted: the one-process mesh of the same grid, the forward
    one = dist.distributed_pipeline(Mesh([[dev]] * POD_PROCESSES), k=PIPELINE_K)(bt, nt)
    out = {"role": "pipeline", "pid": pid, "backends": comm.backends(),
           "mesh_positions": mesh.local_positions, "walls_ms": walls,
           "collectives": collective, "launches": launches}

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
    it; its launches and collective totals after it returns."""
    from seekr_tpu_torch import cli
    from seekr_tpu_torch.ops import count_cuda
    from seekr_tpu_torch.parallel import comm

    count_cuda.reset_launches()
    cli.main(list(argv))
    return {"role": "cli", "pid": comm.process_index(), "backends": comm.backends(),
            "launches": dict(count_cuda.launches),
            "collectives": {name: dict(row) for name, row in comm.stats.items()}}


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
    from seekr_tpu_torch.parallel import dist
    from seekr_tpu_torch.parallel.mesh import make_mesh
    from seekr_tpu_torch.serve import SeekrService, request, serve_forever

    cuda = is_cuda(device)
    cards = torch.cuda.device_count() if cuda else 0
    child_dev = "cuda:0" if cuda else "cpu"
    cpu_flag = [] if cuda else ["--device", "cpu"]
    scale_name = "full" if scale is FULL else "tiny"
    out = {"phase": "processes", "card": state.get("smi"), "cards": cards,
           "processes": POD_PROCESSES, "placement": ("a card each" if cards >= POD_PROCESSES
                                                    else "one shared device")}
    checks, walls = {}, {}
    seed = state["seed"]

    # -- (a) distributed_pipeline over the processes ---------------------------
    t0 = time.perf_counter()
    procs = start_children(lambda pid, coord: ["pipeline", scale_name, str(seed), coord,
                                               str(pid), child_dev], cards)
    try:
        results = child_results(procs, 600, "(a) pipeline")
    finally:
        stop_children(procs)
    walls["a_pipeline_s"] = time.perf_counter() - t0
    launched = add_child_launches(state, results, "processes: pipeline")
    bases, lengths = state["corpus"]
    bt = torch.as_tensor(bases, device=device)
    nt = torch.as_tensor(lengths, device=device)
    one_mesh = make_mesh([torch.device(device)] * POD_PROCESSES)
    one_step = dist.distributed_pipeline(one_mesh, k=PIPELINE_K)
    one_step(bt, nt)
    sync(device)
    one_ms = []
    for _ in range(scale.mesh_reps):  # the one-process mesh of the same grid, in this call
        t0 = time.perf_counter()
        one_step(bt, nt)
        sync(device)
        one_ms.append((time.perf_counter() - t0) * 1e3)
    del bt, nt
    out["backends"] = results[0]["backends"]
    log(f"process groups: {out['backends']}")
    out["pipeline"] = {
        "rows": int(bases.shape[0]), "k": PIPELINE_K,
        "ms_median_by_process": [statistics.median(r["walls_ms"]) for r in results],
        "ms_all_by_process": [r["walls_ms"] for r in results],
        "collective_ms_median_by_process": [
            statistics.median((c["data"]["s"] + c["control"]["s"]) * 1e3
                              for c in r["collectives"]) for r in results],
        "data_bytes_per_run_by_process": [r["collectives"][-1]["data"]["bytes"]
                                          for r in results],
        "one_process_mesh_ms_median": statistics.median(one_ms),
        "one_process_mesh_ms_all": one_ms, "launches": launched,
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
            t0 = t_serve = time.perf_counter()
            procs = start_children(lambda pid, coord: ["cli", *serve_args, "--socket",
                                                       os.path.join(tmp, "pod.sock"),
                                                       "--process_id", str(pid),
                                                       "--coordinator", coord], cards)
            wait_for_socket("pod.sock", procs, 600)
            walls["b_pod_up_s"] = time.perf_counter() - t0
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
                t0 = time.perf_counter()
                answer = request(path, {"seqs": seqs_, "want": list(want), "topk": topk},
                                 timeout=300)
                if not answer.get("ok"):
                    raise AssertionError(f"{path}: {answer}")
                return answer, (time.perf_counter() - t0) * 1e3

            lat = {"pod_q1": [], "one_q1": [], "pod_big": [], "one_big": []}
            sims, tops = [], []
            for r in range(scale.serve_rounds):  # interleaved, the single card beside
                for b in q1[r * scale.serve_q1:(r + 1) * scale.serve_q1]:
                    a, ms = ask("pod.sock", b, ("sim",))
                    lat["pod_q1"].append(ms)
                    ref, ms = ask("one.sock", b, ("sim",))
                    lat["one_q1"].append(ms)
                    sims.append((np.asarray(a["sim"]), np.asarray(ref["sim"])))
                for b in big[r * scale.serve_big:(r + 1) * scale.serve_big]:
                    a, ms = ask("pod.sock", b, ("topk",))
                    lat["pod_big"].append(ms)
                    ref, ms = ask("one.sock", b, ("topk",), SERVE_TOPK + 1)
                    lat["one_big"].append(ms)
                    tops.append((a, ref))
            t0 = time.perf_counter()
            grown = request("pod.sock", {"op": "add_targets", "seqs": grow_in}, timeout=300)
            walls["b_pod_add_targets_s"] = time.perf_counter() - t0
            one.add_targets(grow_in)
            after_pod = np.asarray(ask("pod.sock", check_q, ("sim",))[0]["sim"])
            after_one = np.asarray(ask("one.sock", check_q, ("sim",))[0]["sim"])
            request("one.sock", {"op": "shutdown"}, timeout=60)
            server.join(timeout=60)
            down = request("pod.sock", {"op": "shutdown"}, timeout=60)
            results = child_results(procs, 120, "(b) pod serve")
            walls["b_pod_s"] = time.perf_counter() - t_serve
            launched = add_child_launches(state, results, "processes: pod serve")
            out["serve"] = {
                "targets": len(seqs), "k": SERVE_K,
                "pod_q1_sim_p50_ms": statistics.median(lat["pod_q1"]),
                "one_q1_sim_p50_ms": statistics.median(lat["one_q1"]),
                "phase_7_q1_sim_p50_ms": state.get("serve", {}).get("q1_sim_p50_ms"),
                f"pod_q{scale.serve_big_q}_topk{SERVE_TOPK}_seqs_per_s":
                    scale.serve_big_q / (statistics.median(lat["pod_big"]) / 1e3),
                f"one_q{scale.serve_big_q}_topk{SERVE_TOPK}_seqs_per_s":
                    scale.serve_big_q / (statistics.median(lat["one_big"]) / 1e3),
                f"phase_7_q{scale.serve_big_q}_topk{SERVE_TOPK}_seqs_per_s": state.get(
                    "serve", {}).get(f"q{scale.serve_big_q}_topk{SERVE_TOPK}_seqs_per_s"),
                "latency_ms_all": lat, "launches": launched,
                "collectives_by_process": [r["collectives"] for r in results],
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
            t0 = time.perf_counter()
            procs = start_children(lambda pid, coord: ["cli", *run, "-dp", str(POD_PROCESSES),
                                                       "--num_processes", str(POD_PROCESSES),
                                                       "--process_id", str(pid),
                                                       "--coordinator", coord], cards,
                                   cwd=lambda pid: os.path.join(tmp, f"p{pid}"))
            results = child_results(procs, 600, "(d) pipeline")
            walls["d_pipeline_s"] = time.perf_counter() - t0
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

    out["walls_s"] = walls
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
    state = {"seed": seed, "phase_s": {}}
    for phase in phases:
        log(f"== {phase.__name__}")
        t0 = time.perf_counter()
        phase(device, scale, state)
        state["phase_s"][phase.__name__] = time.perf_counter() - t0
    log(json.dumps({"phase_s": state["phase_s"]}))
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
    from seekr_tpu_torch.ops import count_cuda

    device = torch.device("cuda", 0)
    state = run(device, FULL, args.seed)
    idle = [name for name in count_cuda.KERNELS if state["launches"][name] == 0]
    if idle:
        raise AssertionError(f"kernels of the main path never launched: {idle}")
    for row in state["kernels"]:  # phase 6 launched after phase 5 built the rows
        row["launches"] = state["launches"][row["name"]]
    print(json.dumps({"kernels": state["kernels"]}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
