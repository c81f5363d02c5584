"""One forward of ``SeekrPipeline`` on the allpairs corpus: its peak memory,
its time, the digest of its r and the kernels it launched.

The corpus is the benchmark's (``benchmarks/kbench/corpus.py``, the law of
``benchmarks/configs/lnc_vM25_k6.json``; ``--k`` sets k, ``--m`` the rows).
After one warm forward it measures, with the corpus resident on the card:

* ``peak_bytes``: ``torch.cuda.max_memory_allocated`` over one forward after a
  reset, and ``peak_buffers``, the same over one ``[m, 4^k]`` float32 buffer;
* ``forward_ms``: CUDA-event time of each of ``--forwards`` forwards;
* ``r_sha256``: the digest of one forward's r (the same bits, the same digest);
* ``launches``: the device kernels, copies and sets of one forward, in
  order, under ``torch.profiler`` (the benchmark's ``kbench/trace.Slice``),
  and their device ms summed by kind: ``gemm``, ``count``, ``other``.

Prints ``CHAIN {json}``.  It uses only ``SeekrPipeline``'s public methods, so
it runs on a checkout from before the chain was blocked too (where one that
does not fit raises the card's out-of-memory error).  Run from the root of a
checkout on a card:
``python exp/torch_blocked_chain.py --k 9 [--m 13000] [--seed 1] [--forwards 3]``
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks")]

import torch  # noqa: E402

from kbench import corpus  # noqa: E402
from kbench.trace import Slice  # noqa: E402
from seekr_tpu_torch import SeekrPipeline  # noqa: E402

LAW = os.path.join(ROOT, "benchmarks", "configs", "lnc_vM25_k6.json")


def kind(name: str) -> str:
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "gemm"
    return "count" if "count_" in low else "other"


def launches(pipe, bases, lengths):
    trace = Slice()
    trace.start()
    pipe.forward(bases, lengths)
    trace.stop()
    events = sorted(trace.events, key=lambda e: e[1])
    by_kind = {}
    for name, start, end in events:
        by_kind[kind(name)] = by_kind.get(kind(name), 0.0) + 1e3 * (end - start)
    return [name for name, _, _ in events], by_kind


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--m", type=int, default=13000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--forwards", type=int, default=3)
    args = ap.parse_args(argv)

    device = torch.device("cuda", 0)
    with open(LAW) as fh:
        law = json.load(fh)
    bases, lengths = corpus.make_corpus(args.m, law, corpus.generator(device, args.seed, 0))
    pipe = SeekrPipeline(k=args.k, device=device)
    pipe.forward(bases, lengths)  # warm: kernel builds, cuBLAS set-up
    torch.cuda.synchronize()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device)
    r = pipe.forward(bases, lengths)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    digest = hashlib.sha256(r.cpu().numpy().tobytes()).hexdigest()
    nan = bool(torch.isnan(r).any())
    del r

    times = []
    for _ in range(args.forwards):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipe.forward(bases, lengths)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    Slice.warm()
    names, by_kind = launches(pipe, bases, lengths)

    buffer = args.m * 4 ** args.k * 4
    print("CHAIN " + json.dumps({
        "card": torch.cuda.get_device_name(device), "k": args.k, "m": args.m,
        "lpad": int(bases.shape[1]), "seed": args.seed, "resident_bytes": resident,
        "peak_bytes": peak, "peak_buffers": peak / buffer, "forward_ms": times,
        "forward_ms_median": statistics.median(times), "r_sha256": digest, "r_nan": nan,
        "n_launches": len(names), "device_ms_by_kind": by_kind, "launches": names}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
