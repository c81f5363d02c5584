"""Where the host waits inside ``SeekrPipeline.forward``.

``ops/pearson.divide`` makes its divisor with ``torch.tensor(float(n),
device=...)``, a copy from pageable host memory, which waits for the stream.
This times the forward on the ``lnc_vM25_k6`` corpus (``benchmarks/configs``)
three ways: as it is, with the divisor made by ``torch.full`` (a fill kernel,
no copy), and as it is again.  For each: the host ms until ``forward``
returns, the host ms until ``divide`` is first entered, and the wall ms with a
synchronize; the median of ``--forwards`` forwards each.  It also says whether
the two divisors give bitwise the same r.  Prints ``DIVIDE {json}``.

Run from the root of the repository on a card:
``python exp/torch_forward_divide.py [--forwards 10] [--seed 1]``
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks")]

import torch

from kbench import corpus
from seekr_tpu_torch import SeekrPipeline
from seekr_tpu_torch.ops import pearson as ops_pearson

AS_IS = ops_pearson.divide


def by_fill(x, n):
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def timed(pipe, bases, lengths, divide, forwards: int):
    reached = []

    def marked(x, n):
        reached.append(time.perf_counter())
        return divide(x, n)

    ops_pearson.divide = marked
    host, to_divide, wall = [], [], []
    try:
        for _ in range(forwards):
            torch.cuda.synchronize()
            reached.clear()
            t0 = time.perf_counter()
            out = pipe.forward(bases, lengths)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append(1e3 * (t1 - t0))
            to_divide.append(1e3 * (reached[0] - t0))
            wall.append(1e3 * (t2 - t0))
    finally:
        ops_pearson.divide = AS_IS
    return out, {"host_ms": statistics.median(host),
                 "host_ms_to_divide": statistics.median(to_divide),
                 "wall_ms": statistics.median(wall)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--forwards", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    with open(os.path.join(ROOT, "benchmarks/configs/lnc_vM25_k6.json")) as fh:
        cfg = json.load(fh)
    device = torch.device("cuda", 0)
    bases, lengths = corpus.make_corpus(cfg["transcripts"], cfg,
                                        corpus.generator(device, args.seed, 0))
    pipe = SeekrPipeline(k=cfg["k"], log2=cfg["log2"], device=device)
    for divide in (AS_IS, by_fill):  # warm both
        timed(pipe, bases, lengths, divide, 2)
    r_as_is, out = timed(pipe, bases, lengths, AS_IS, args.forwards)
    out = {"as_is": out}
    r_fill, out["fill"] = timed(pipe, bases, lengths, by_fill, args.forwards)
    _, out["as_is_again"] = timed(pipe, bases, lengths, AS_IS, args.forwards)
    out["fill_bitwise_as_is"] = bool(torch.equal(r_as_is, r_fill))
    print("DIVIDE " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
