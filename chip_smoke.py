#!/usr/bin/env python3
"""Drive the seekr_tpu_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one NVIDIA card, ``nvcc`` and
PyTorch built for CUDA.  It builds the CUDA kernels from ``seekr_tpu_torch/csrc``
and runs these phases, each a function of (device, scale, state):

1. environment: torch and CUDA versions, ``nvcc --version``, the card's name and
   power limit, and the kernel build (with ptxas' register and spill lines);
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
4. the same corpus through ``KmerCounter(fasta).get_counts()`` and ``pearson``
   (the blocked path): exactly symmetric, within 1e-4 of phase 3; a FASTA with
   two transcripts past the long-sequence threshold against the numpy oracle;
   and ``KmerCounter(k=9)`` (the large-k kernel) against the numpy oracle;
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
   its counts and its GEMM.

Launch counts are set to 0 just before phases 3, 4 and 6 drive the main path
and read just after; the run fails if a kernel of the path was not launched.
The last lines are the ``kernels`` JSON line, the card's ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
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


FULL = Scale(corpus_m=13_000, corpus_cap=4096, kernel_m=2048, kernel_m_big=256,
             kernel_lmax=4096, large_k_m=1024, long_lengths=(20_000, 40_000), reps=10,
             stats_subset=100_000, stats_query=1000, stats_self=2048, stats_pairs=100_000,
             stats_plain_cells=4096)
TINY = Scale(corpus_m=96, corpus_cap=1024, kernel_m=24, kernel_m_big=6,
             kernel_lmax=600, large_k_m=12, long_lengths=(16_500, 17_000), reps=2,
             stats_subset=600, stats_query=16, stats_self=24, stats_pairs=500,
             stats_plain_cells=200)


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


def phase_pipeline(device, scale, state):
    """Main path, pipeline entry: SeekrPipeline(k=6, Log2.post).forward."""
    import torch

    from seekr_tpu_torch.models.pipeline import SeekrPipeline
    from seekr_tpu_torch.ops import count_cuda
    from seekr_tpu_torch.ops.count import count_graph
    from seekr_tpu_torch.ops.normalize import normalize_graph
    from seekr_tpu_torch.ops.pearson import _row_standardize, matmul_nt

    bases, lengths = make_corpus(scale.corpus_m, scale.corpus_cap, state["seed"])
    state["corpus"] = (bases, lengths)
    m = bases.shape[0]
    log(f"corpus: m={m}, Lpad={bases.shape[1]}, {int(lengths.sum())} bases, "
        f"median length {int(np.median(lengths))}")
    pipe = SeekrPipeline(k=PIPELINE_K, log2="Log2.post", device=device)
    bt = torch.as_tensor(bases, device=device)  # set-up: one upload of the corpus
    nt = torch.as_tensor(lengths, device=device)

    count_cuda.reset_launches()
    for _ in range(3):
        sim = pipe.forward(bt, nt)
    sync(device)
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
        out["pearson_gemm_ms"] = cuda_ms(lambda: matmul_nt(operand, operand), scale.reps)
        gemm_flop = 2.0 * m * m * operand.shape[1]
        out["pearson_gemm_tflop_per_s"] = gemm_flop / (out["pearson_gemm_ms"] / 1e3) / 1e12
        del normalized, operand
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

    m = len(seqs)
    out = {"phase": "counter", "m": m, "get_counts_s": t1 - t0, "pearson_s": t2 - t1,
           "long_and_large_k_s": t3 - t2}
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
    from seekr_tpu_torch.io.encode import encode_seqs
    from seekr_tpu_torch.io.fast_csv import write_labeled_csv
    from seekr_tpu_torch.io.fasta import Reader
    from seekr_tpu_torch.io.stream import stream_pearson
    from seekr_tpu_torch.models.counter import _MAX_ROWS_PER_BUCKET, KmerCounter
    from seekr_tpu_torch.models.pearson import pearson
    from seekr_tpu_torch.ops.ecdf import SortedBackground
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

    timed("fasta_parse_s", lambda: Reader("corpus.fa").get_seqs())
    timed("encode_s", lambda: encode_seqs(seqs, STATS_K, max_rows_per_bucket=_MAX_ROWS_PER_BUCKET))
    counts = timed("counter_s", lambda: KmerCounter(
        "corpus.fa", k=STATS_K, silent=True, device=device).get_counts_device())
    timed("blocked_gemm_and_copy_s", lambda: stream_pearson(counts, counts, _Discard(),
                                                            device=device))
    triu = timed("similarity_triu_s", lambda: similarity_triu(counts, device=device))
    np.random.seed(state["seed"])
    timed("random_choice_s", lambda: np.random.choice(
        triu, size=min(scale.stats_subset, len(triu)), replace=False))
    del triu
    sim = timed("pearson_query_s", lambda: pearson(counts[:scale.stats_query], counts,
                                                   device=device))
    timed("ecdf_s", lambda: SortedBackground(bkg).pvals(sim))
    name, _, params = fitres[0]
    timed("fast_cdf_s", lambda: fast_cdf(name, params, sim))
    timed("multipletests_s", lambda: multipletests(p_emp.values, method="fdr_bh"))
    timed("write_pvals_csv_s", lambda: write_labeled_csv(
        "pvals.csv", p_emp.values, p_emp.index, p_emp.columns))
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


PHASES = (phase_env, phase_kernels, phase_pipeline, phase_counter, phase_timing,
          phase_stats)


def run(device, scale, seed: int = 0) -> dict:
    """Run every phase in order; any failure raises.  Returns the state."""
    state = {"seed": seed}
    for phase in PHASES:
        log(f"== {phase.__name__}")
        phase(device, scale, state)
    return state


def main(argv=None) -> int:
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
