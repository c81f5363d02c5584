"""The port's plain k-mer count (seekr_tpu_torch.ops.count) against seekr_tpu.

``count_torch`` is the plain PyTorch version of the CUDA kernel and what the
port runs on the CPU.  It must be BITWISE equal to seekr_tpu's Pallas kernel
(interpret mode on the CPU) and to its XLA path ``_count_impl``: all three count
exact integers and scale by one float32 divide and one float32 multiply.  The
cases are those of tests/test_count_pallas.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekr_tpu.ops import count as jax_count
from seekr_tpu.ops.count_pallas import count_kmers_pallas
from seekr_tpu_torch.ops import count as torch_count
from seekr_tpu_torch.ops.count import count_graph, count_torch

DIGIT2CHAR = np.array(list("AGTCN"))


def random_case(rng, m, L, k, with_invalid=True):
    hi = 5 if with_invalid else 4
    bases = rng.integers(0, hi, size=(m, L), dtype=np.int8)
    lengths = rng.integers(k, L + 1, size=m).astype(np.int32)
    for r in range(m):
        bases[r, lengths[r]:] = 4
    return bases, lengths


def port(bases, lengths, k, **kw):
    return count_torch(torch.from_numpy(bases), torch.from_numpy(lengths), k, **kw).numpy()


def pallas(bases, lengths, k, **kw):
    return np.asarray(count_kmers_pallas(jnp.asarray(bases), jnp.asarray(lengths), k,
                                         interpret=True, **kw))


def xla(bases, lengths, k, **kw):
    return np.asarray(jax_count._count_impl(jnp.asarray(bases), jnp.asarray(lengths), k, **kw))


def assert_bitwise(got, *refs):
    for ref in refs:
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_matches_pallas_and_xla(k):
    rng = np.random.default_rng(k)
    bases, lengths = random_case(rng, 9, 515, k)
    assert_bitwise(port(bases, lengths, k), pallas(bases, lengths, k), xla(bases, lengths, k))


def test_multi_chunk_rows():
    rng = np.random.default_rng(1)
    bases, lengths = random_case(rng, 8, 5000, 6)
    assert_bitwise(port(bases, lengths, 6), pallas(bases, lengths, 6), xla(bases, lengths, 6))


def test_short_and_degenerate_rows():
    # a row shorter than k, a row of exactly one window, an all-N row
    k = 5
    rng = np.random.default_rng(9)
    bases, lengths = random_case(rng, 11, 260, k)
    lengths[0] = k
    bases[0, :k] = [0, 1, 2, 3, 0]
    bases[0, k:] = 4
    lengths[1] = k - 1
    bases[1, :] = 4
    bases[2, :lengths[2]] = 4
    lengths[3] = 0
    bases[3, :] = 4
    got = port(bases, lengths, k)
    assert_bitwise(got, pallas(bases, lengths, k), xla(bases, lengths, k))
    assert got[1].sum() == 0 and got[2].sum() == 0 and got[3].sum() == 0
    assert got[0].sum() == 1000.0


def test_unscaled_integer_counts():
    k = 5
    rng = np.random.default_rng(3)
    bases, lengths = random_case(rng, 7, 400, k)
    got = port(bases, lengths, k, scaled=False)
    assert_bitwise(got, pallas(bases, lengths, k, scaled=False),
                   xla(bases, lengths, k, scaled=False))
    assert got.sum() > 0 and np.all(got == np.round(got))


@pytest.mark.parametrize("lpad", [2048, 2053, 2054, 4101])
def test_chunk_boundary_lengths(lpad):
    k = 6
    rng = np.random.default_rng(lpad)
    bases, lengths = random_case(rng, 5, lpad, k)
    lengths[0] = lpad
    bases[0, :] = rng.integers(0, 4, size=lpad)
    assert_bitwise(port(bases, lengths, k), pallas(bases, lengths, k), xla(bases, lengths, k))


@pytest.mark.parametrize("k", [7, 8])
def test_large_k(k):
    rng = np.random.default_rng(k)
    bases, lengths = random_case(rng, 5, 700, k)
    assert_bitwise(port(bases, lengths, k), pallas(bases, lengths, k), xla(bases, lengths, k))


@pytest.mark.parametrize("k", [9, 10])
def test_k9_k10_against_xla(k):
    # the range of seekr_tpu's hi-blocked kernel, at m <= 4
    rng = np.random.default_rng(100 + k)
    bases, lengths = random_case(rng, 4, 120, k)
    got = port(bases, lengths, k)
    assert_bitwise(got, xla(bases, lengths, k))
    seqs = ["".join(DIGIT2CHAR[row[:n]]) for row, n in zip(bases, lengths)]
    np.testing.assert_allclose(got, jax_count.count_kmers_host(seqs, k), rtol=1e-4, atol=1e-4)


def test_k1_against_xla():
    rng = np.random.default_rng(11)
    bases, lengths = random_case(rng, 6, 300, 1)
    assert_bitwise(port(bases, lengths, 1), xla(bases, lengths, 1))


@pytest.mark.parametrize("k", [3, 6, 9])
def test_unflattened_counts(k):
    # flat=False: the [m, n_hi, n_lo] view whose row-major bytes are the flat
    # counts; its split is the Pallas kernel's (the XLA path splits otherwise)
    rng = np.random.default_rng(20 + k)
    bases, lengths = random_case(rng, 4, 300, k)
    got = port(bases, lengths, k, flat=False)
    if k <= 8:
        assert_bitwise(got, pallas(bases, lengths, k, flat=False))
    assert_bitwise(got.reshape(4, -1), xla(bases, lengths, k, flat=False).reshape(4, -1),
                   port(bases, lengths, k))


def test_count_graph_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    bases, lengths = random_case(rng, 6, 200, 4)
    got = count_graph(torch.from_numpy(bases), torch.from_numpy(lengths), 4).numpy()
    assert_bitwise(got, xla(bases, lengths, 4))
    dev = torch_count.count_kmers_device(bases, lengths, 4, device="cpu").numpy()
    assert_bitwise(dev, got)


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_split_long_digits_matches(n_chunks):
    rng = np.random.default_rng(n_chunks)
    digits = rng.integers(0, 5, size=1001, dtype=np.int8)
    got, n_got = torch_count.split_long_digits(digits, 6, n_chunks)
    want, n_want = jax_count.split_long_digits(digits, 6, n_chunks)
    assert n_got == n_want
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("length", [3, 5000, 20000])
def test_count_kmers_long_matches(length):
    rng = np.random.default_rng(length)
    digits = rng.integers(0, 5, size=length, dtype=np.int8)
    got = torch_count.count_kmers_long(digits, 6, target_chunk=4096, device="cpu")
    want = jax_count.count_kmers_long(digits, 6, target_chunk=4096)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_count_kmers_host_copy_matches():
    seqs = ["ACGTNNACGTTGCA", "AAAAAAAA", "AC", "acgtACGT"]
    for k in (1, 2, 3):
        np.testing.assert_array_equal(torch_count.count_kmers_host(seqs, k),
                                      jax_count.count_kmers_host(seqs, k))
