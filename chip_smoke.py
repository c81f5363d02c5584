#!/usr/bin/env python3
"""Drive the seekr_tpu_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one NVIDIA card, ``nvcc`` and
PyTorch built for CUDA.  It builds the CUDA kernels from ``seekr_tpu_torch/csrc``
and runs these phases, each a function of (device, scale, state):

1. environment: torch and CUDA versions, ``nvcc --version``, the card's name and
   power limit, and the kernel build (with ptxas' register and spill lines);
2. every count kernel against its plain PyTorch version (``count_torch``) at
   k = 1..10, with N bases, short, zero-length and padded rows, scaled and raw,
   flat and unflattened: bitwise equal (``torch.equal``);
3. the main path through ``SeekrPipeline(k=6, log2="Log2.post").forward`` on a
   synthetic stand-in of the reference's default background corpus (12,996
   GENCODE vM25 lncRNAs: here 13,000 transcripts with lognormal lengths, median
   about 1.4 kb, capped at 4,096), timed, and checked against a float64
   recomputation of normalize + Pearson from the kernel's counts (max abs 1e-4);
4. the same corpus through ``KmerCounter(fasta).get_counts()`` and ``pearson``
   (the blocked path): exactly symmetric, within 1e-4 of phase 3; a FASTA with
   two transcripts past the long-sequence threshold against the numpy oracle;
   and ``KmerCounter(k=9)`` (the large-k kernel) against the numpy oracle;
5. each kernel at its main-path shapes: its time, its bound, the plain version's
   time and a library yardstick.

Launch counts are set to 0 just before phases 3 and 4 drive the main path and
read just after; the run fails if a kernel of the path was not launched.  The
last lines are the ``kernels`` JSON line, the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
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
SOURCE = "seekr_tpu_torch/csrc/count_kmers.cu"
REPLACES = {  # kernel -> the TPU kernel body it replaces
    "count_kmers_smem": "seekr_tpu/ops/count_pallas.py:67",
    "count_kmers_gmem": "seekr_tpu/ops/count_pallas.py:125",
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


FULL = Scale(corpus_m=13_000, corpus_cap=4096, kernel_m=2048, kernel_m_big=256,
             kernel_lmax=4096, large_k_m=1024, long_lengths=(20_000, 40_000), reps=10)
TINY = Scale(corpus_m=96, corpus_cap=1024, kernel_m=24, kernel_m_big=6,
             kernel_lmax=600, large_k_m=12, long_lengths=(16_500, 17_000), reps=2)


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


def kernel_case(rng, m: int, lmax: int, k: int):
    """Count-kernel inputs with every edge: N bases, a zero-length row, a row
    shorter than k, a full-width row, an all-N row, padded ragged rows."""
    lengths = rng.integers(min(512, lmax // 2), lmax + 1, size=m).astype(np.int32)
    bases = rng.integers(0, 4, size=(m, lmax), dtype=np.int8)
    bases[rng.random((m, lmax)) < 0.01] = 4
    lengths[0] = 0
    lengths[1] = k - 1
    lengths[2] = lmax
    bases[3, :] = 4
    bases[np.arange(lmax)[None, :] >= lengths[:, None]] = 4
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
    for k in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10):
        m = scale.kernel_m if k <= 8 else scale.kernel_m_big
        b, n = kernel_case(rng, m, scale.kernel_lmax, k)
        bt = torch.as_tensor(b, device=device)
        nt = torch.as_tensor(n, device=device)
        worst = 0.0
        for scaled in (True, False):
            for flat in (True, False):
                got = count_kmers_cuda(bt, nt, k, scaled=scaled, flat=flat)
                want = count_torch(bt, nt, k, scaled=scaled, flat=flat)
                sync(device)
                if got.shape != want.shape or not torch.equal(got, want):
                    raise AssertionError(
                        f"{kernel_for(k)} differs from count_torch at k={k} "
                        f"scaled={scaled} flat={flat}: max abs "
                        f"{(got - want).abs().max().item()}")
                worst = max(worst, (got - want).abs().max().item())
                del got, want
        record_err(state, kernel_for(k), worst)
        log(f"k={k:2d} {kernel_for(k)} m={m} Lpad={scale.kernel_lmax}: torch.equal, "
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

    m, lpad = b.shape
    w = lpad - k + 1
    d = b.to(torch.int64)
    bad = d >= 4
    d = d.masked_fill(bad, 0)
    code = torch.zeros((m, w), dtype=torch.int64, device=b.device)
    invalid = torch.zeros((m, w), dtype=torch.bool, device=b.device)
    for j in range(k):
        code = code * 4 + d[:, j:j + w]
        invalid |= bad[:, j:j + w]
    valid = (torch.arange(w, device=b.device)[None, :] < (n.to(torch.int64) - (k - 1))[:, None])
    code += torch.arange(m, device=b.device)[:, None] * (1 << (2 * k))
    return code[valid & ~invalid]


def phase_timing(device, scale, state):
    """Each kernel at its main-path shapes: time, bound, plain and library times.

    count_kmers_smem: the pipeline's one [m, 4096] launch at k = 6.
    count_kmers_gmem: the k = 9 counter run's bucket launches, summed.
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
        "count_kmers_gmem": (LARGE_K, shapes_of(state["large_k_seqs"], LARGE_K)),
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
        ms = sum(cuda_ms(lambda b=b, n=n: count_kmers_cuda(b, n, k), scale.reps)
                 for b, n in inputs)
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


PHASES = (phase_env, phase_kernels, phase_pipeline, phase_counter, phase_timing)


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
    print(json.dumps({"kernels": state["kernels"]}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
