"""The forward's self Gram: float32 SGEMM against the split TF32 product.

On the ``lnc_vM25_k6`` corpus (``benchmarks/configs``), row-standardized at
k = 6 (13,000 x 4,096), this reads which kernels cuBLAS launches for each
product (``torch.profiler``; whether their names match the benchmark's Gram
pattern ``benchmarks/rooflines/gram.py``), times each part with CUDA events,
and holds r of each route (split, float32, TF32) to float64, on the diagonal
and off it.  ``--widths`` sweeps ``ops.pearson.TF32_SUM_COLUMNS`` (the columns
one product of the large term ``hi hi^T`` sums): the term's time, the split
Gram's and r's error for each.  With ``--k9`` it then times whole forwards at
k = 9 under ``highest`` and ``high``, and their peak memory.  Prints one
``SPLIT {json}`` line.

Run from the root of the repository on a card:
``python exp/torch_split_gram.py [--reps 10] [--seed 1] [--widths 4096,1024,512] [--k9]``
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks")]

import torch

from kbench import corpus
from rooflines import gram as gram_roofline
from seekr_tpu_torch import SeekrPipeline
from seekr_tpu_torch.ops import pearson as P
from seekr_tpu_torch.ops.precision import pearson_precision


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--widths", default="")
    ap.add_argument("--k9", action="store_true")
    args = ap.parse_args()
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "card": smi}
    with open(os.path.join(ROOT, "benchmarks/configs/lnc_vM25_k6.json")) as fh:
        cfg = json.load(fh)
    bases, lengths = corpus.make_corpus(cfg["transcripts"], cfg,
                                        corpus.generator(device, args.seed, 0))
    pipe = SeekrPipeline(k=cfg["k"], log2=cfg["log2"], device=device)
    a = P._row_standardize(pipe.counts(bases, lengths)[0])
    m, n = a.shape
    hi, lo = P.split_tf32(a)
    x = hi @ lo.T

    def tf32(fn):
        def run():
            with pearson_precision(tf32=True):
                return fn()
        return run

    parts = {
        "fp32_gram": lambda: P.gram(a, a),
        "tf32_mm": tf32(lambda: hi @ lo.T),
        "tf32_addmm": tf32(lambda: x.addmm_(hi, hi.T)),
        "split_tf32": lambda: P.split_tf32(a),
        "x_plus_xt": lambda: x + x.T,
        "split_gram": lambda: P.split_gram(a),
    }
    pattern = re.compile(gram_roofline.KERNEL)
    out["kernels"] = {}
    for name, fn in parts.items():
        ks = kernels(fn)
        out["kernels"][name] = {k: round(v, 4) for k, v in ks.items()}
        out["kernels"][name + "_gram_pattern_ms"] = round(
            sum(v for k, v in ks.items() if pattern.search(k)), 4)
    out["ms"] = {name: cuda_ms(fn, args.reps) for name, fn in parts.items()}
    flop = 2.0 * m * m * n
    out["tflop_per_s"] = {name: flop / (out["ms"][name] / 1e3) / 1e12
                          for name in ("fp32_gram", "tf32_mm", "tf32_addmm")}
    del x, hi, lo

    a64 = a.double()
    want = (a64 @ a64.T) / n
    del a64
    diag = torch.eye(m, dtype=torch.bool, device=device)

    def err(r):
        e = (r.double() - want).abs()
        return {"r_max_abs_err": e.max().item(), "diagonal": e[diag].max().item(),
                "off_diagonal": e[~diag].max().item()}

    errs = {}
    for route, value in (("split", "high"), ("fp32", "highest"), ("tf32", "default")):
        before = dict(P.gram_routes)
        errs[route] = err(with_precision(value, lambda: P.divide(P.self_gram(a), n)))
        errs[route]["route_counted"] = [k for k in P.gram_routes
                                        if P.gram_routes[k] != before[k]]
    out["vs_f64"] = errs
    if args.widths:
        hi = P.split_tf32(a)[0]
        sweep, saved = {}, P.TF32_SUM_COLUMNS
        for w in (int(v) for v in args.widths.split(",")):
            P.TF32_SUM_COLUMNS = w
            with pearson_precision(tf32=True):
                hh_ms = cuda_ms(lambda: P._add_hi_hi(None, hi), args.reps)
                names = sorted(kernels(lambda: P._add_hi_hi(None, hi)))
            sweep[w] = {"hi_hi_ms": hh_ms, "split_gram_ms": cuda_ms(lambda: P.split_gram(a),
                                                                     args.reps),
                        "kernels": names, **err(P.divide(P.split_gram(a), n))}
        P.TF32_SUM_COLUMNS = saved
        out["widths"] = sweep
        del hi
    del want, a, diag

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
    print("SPLIT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
