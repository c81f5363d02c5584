"""Transcripts made from the seed, on the device, in a few large calls.

The law is the configuration's: lognormal lengths (median, sigma), none under
``length_min`` and none cut from above, uniform bases, about ``n_per_base`` N
bases.
Every seed gets the same set of lengths (the law's quantiles at evenly spaced
points) in another order, so seeds change the letters and the order of the
work, not its amount.  Digits are ``A G T C`` = 0..3 and 4 = N or padding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LETTERS = np.frombuffer(b"AGTCN", dtype=np.uint8)


def seed_of(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for one stream of the run's seed."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), *stream]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def generator(device, seed: int, *stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, *stream))
    return g


def stratified_lengths(n: int, law: dict, device) -> torch.Tensor:
    """The law's quantiles at ``(i + 0.5) / n``: the same ``n`` lengths for any seed."""
    u = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    length = torch.exp(math.log(law["length_median"]) + law["length_sigma"] * z)
    return length.clamp(min=law["length_min"]).to(torch.int32)


def make_corpus(n: int, law: dict, gen: torch.Generator):
    """``(bases [n, longest] int8, lengths [n] int32)`` on ``gen``'s device."""
    dev = gen.device
    lengths = stratified_lengths(n, law, dev)
    cap = int(lengths.max())
    lengths = lengths[torch.randperm(n, generator=gen, device=dev)]
    bases = torch.randint(0, 4, (n, cap), generator=gen, device=dev, dtype=torch.int8)
    n_mask = torch.rand((n, cap), generator=gen, device=dev) < law["n_per_base"]
    pad = torch.arange(cap, device=dev)[None, :] >= lengths[:, None]
    bases.masked_fill_(n_mask | pad, 4)
    return bases, lengths


def to_strings(bases: torch.Tensor, lengths: torch.Tensor) -> list[str]:
    chars = LETTERS[bases.cpu().numpy()]
    return [row[:n].tobytes().decode() for row, n in zip(chars, lengths.cpu().tolist())]


def write_fasta(path, seqs, prefix: str = "t") -> None:
    with open(path, "w") as fh:
        fh.write("".join(f">{prefix}{i}\n{s}\n" for i, s in enumerate(seqs)))

