"""The forward's self Gram: the symmetric split-TF32 kernel against cuBLAS.

On the ``lnc_vM25_k6`` corpus (``benchmarks/configs``), row-standardized at k = 6
(13,000 x 4,096): the kernels each part launches (``torch.profiler``; whether
their names match the benchmark's Gram pattern ``benchmarks/rooflines/gram.py``),
the kernel alone (a first-and-last block, and a middle block of k = 9, which reads
and writes r) against the cuBLAS composition it replaced
(``chip_smoke.cublas_composition``), and r of each route (split, float32, TF32)
against float64, on the diagonal and off it.  With ``--k9`` it then times whole
forwards at k = 9 under ``highest`` and ``high``, and their peak memory.  Prints
one ``SPLIT {json}`` line.  The kernel's fold (``kFoldColumns`` in
``csrc/sym_gemm.cu``, ``ops/sym_gemm_cuda.TF32_SUM_COLUMNS``) is a constant: a
sweep of it edits both and rebuilds.

Run from the root of the repository on a card:
``python exp/torch_split_gram.py [--reps 10] [--seed 1] [--k9]``
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks")]

import torch

from chip_smoke import cublas_composition
from kbench import corpus
from rooflines import gram as gram_roofline
from seekr_tpu_torch import SeekrPipeline
from seekr_tpu_torch.ops import pearson as P
from seekr_tpu_torch.ops import sym_gemm_cuda as S
from seekr_tpu_torch.utils import build


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernels(fn):
    """{kernel name (its first 100 characters): device ms} of one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name[:100]
            out[name] = out.get(name, 0.0) + ev.device_time / 1e3
    return out


def with_precision(value, fn):
    saved = os.environ.get("SEEKR_TPU_MATMUL_PRECISION")
    os.environ["SEEKR_TPU_MATMUL_PRECISION"] = value
    try:
        return fn()
    finally:
        if saved is None:
            del os.environ["SEEKR_TPU_MATMUL_PRECISION"]
        else:
            os.environ["SEEKR_TPU_MATMUL_PRECISION"] = saved


def symmetric(r):
    """r equal to its transpose bit for bit, NaN included."""
    bits = r.view(torch.int32)
    return bool(torch.equal(bits, bits.T))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--k9", action="store_true")
    args = ap.parse_args()
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "card": smi}
    start = time.perf_counter()
    build.load_library()
    out["build_s"] = time.perf_counter() - start
    out["ptxas"] = [line for line in build.build_log().splitlines()
                    if "sym_split" in line or "registers" in line or "spill" in line][-12:]
    print("BUILD " + json.dumps(out), flush=True)

    with open(os.path.join(ROOT, "benchmarks/configs/lnc_vM25_k6.json")) as fh:
        cfg = json.load(fh)
    bases, lengths = corpus.make_corpus(cfg["transcripts"], cfg,
                                        corpus.generator(device, args.seed, 0))
    pipe = SeekrPipeline(k=cfg["k"], log2=cfg["log2"], device=device)
    a = P._row_standardize(pipe.counts(bases, lengths)[0])
    m, n = a.shape
    hi, lo = P.split_tf32(a)
    r = torch.empty((m, m), device=device)

    def kernel(first=True, last=True):
        return S.sym_split_gemm(hi, lo, r, first, last, n)

    parts = {
        "kernel": kernel,
        "kernel_middle_block": lambda: kernel(False, False),
        "composition": lambda: cublas_composition(hi, lo, n),
        "fp32_gram": lambda: P.gram(a, a),
        "split_tf32": lambda: P.split_tf32(a),
        "split_gram": lambda: P.split_gram(a, n),
    }
    pattern = re.compile(gram_roofline.KERNEL)
    out["kernels"] = {}
    for name, fn in parts.items():
        ks = kernels(fn)
        out["kernels"][name] = {k: round(v, 4) for k, v in ks.items()}
        out["kernels"][name + "_gram_pattern_ms"] = round(
            sum(v for k, v in ks.items() if pattern.search(k)), 4)
    out["ms"] = {name: cuda_ms(fn, args.reps) for name, fn in parts.items()}
    triangle = 3 * 2.0 * n * (m * (m + 1) / 2)
    out["kernel_tflop_per_s"] = triangle / (out["ms"]["kernel"] / 1e3) / 1e12
    out["kernel_bound_ms"] = triangle / 494.7e12 * 1e3
    out["gram_roofline_alone"] = 100 * (2.0 * m * m * n / 494.7e12 * 1e3) / out["ms"]["kernel"]
    print("TIMES " + json.dumps(out["ms"]), flush=True)

    a64 = a.double()
    want = (a64 @ a64.T) / n
    del a64
    diag = torch.eye(m, dtype=torch.bool, device=device)

    def err(got):
        e = (got.double() - want).abs()
        return {"r_max_abs_err": e.max().item(), "diagonal": e[diag].max().item(),
                "off_diagonal": e[~diag].max().item(), "symmetric": symmetric(got)}

    errs = {"composition": err(cublas_composition(hi, lo, n))}
    for route, value in (("split", "high"), ("fp32", "highest"), ("tf32", "default")):
        before = dict(P.gram_routes)
        errs[route] = err(with_precision(value, lambda: P.self_gram(a, n)))
        errs[route]["route_counted"] = [k for k in P.gram_routes
                                        if P.gram_routes[k] != before[k]]
    out["vs_f64"] = errs
    print("ERRS " + json.dumps(errs), flush=True)
    del want, a, diag, hi, lo, r

    def forward_ms(value):
        return with_precision(value, lambda: cuda_ms(lambda: pipe.forward(bases, lengths),
                                                     args.reps))

    out["forward_ms_k6"] = [(v, forward_ms(v)) for v in ("highest", "high", "high", "highest")]
    if args.k9:
        pipe = SeekrPipeline(k=9, log2=cfg["log2"], device=device)
        out["forward_ms_k9"], out["peak_bytes_k9"] = {}, {}
        for v in ("highest", "high"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            out["forward_ms_k9"][v] = with_precision(
                v, lambda: cuda_ms(lambda: pipe.forward(bases, lengths), 3))
            out["peak_bytes_k9"][v] = torch.cuda.max_memory_allocated(device)
        ks = with_precision("high", lambda: kernels(lambda: pipe.forward(bases, lengths)))
        out["k9_forward_kernels_top"] = dict(sorted(ks.items(), key=lambda kv: -kv[1])[:8])
    out["gram_routes"] = dict(P.gram_routes)
    out["sym_gemm"] = dict(P.sym_gemm)
    print("SPLIT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
