"""The port's main path (SeekrPipeline, KmerCounter + pearson) against seekr_tpu.

The same numpy inputs go through both packages on the CPU.  Count matrices
agree bitwise where no column statistic is computed; normalized matrices and
Pearson r within 1e-5 abs, NaN where seekr_tpu has NaN.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from __graft_entry__ import _example_batch  # noqa: E402
from seekr_tpu.models.counter import KmerCounter as JaxCounter  # noqa: E402
from seekr_tpu.models.pearson import pearson as jax_pearson  # noqa: E402
from seekr_tpu.models.pipeline import SeekrPipeline as JaxPipeline  # noqa: E402
from seekr_tpu_torch import BasicCounter, KmerCounter, SeekrPipeline, pearson  # noqa: E402
from seekr_tpu_torch.models import counter as counter_mod  # noqa: E402

TOL = dict(rtol=0, atol=1e-5, equal_nan=True)
FIXTURES = Path(__file__).resolve().parent / "fixtures"


def batch(m, L, k, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(k + 1, L + 1, size=m).astype(np.int32)
    bases = rng.integers(0, 4, size=(m, L), dtype=np.int8)
    for r in range(m):
        bases[r, lengths[r]:] = 4
    return bases, lengths


def test_forward_matches_on_example_batch_with_nan():
    bases, lengths = _example_batch()
    want = np.asarray(JaxPipeline(k=6).forward(bases, lengths))
    got = SeekrPipeline(k=6, device="cpu").forward(bases, lengths).numpy()
    assert np.isnan(want).any()  # 16 short rows leave k-mers unseen
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_matches_without_nan():
    bases, lengths = batch(256, 2047, 6)
    want = np.asarray(JaxPipeline(k=6).forward(bases, lengths))
    got = SeekrPipeline(k=6, device="cpu").forward(bases, lengths).numpy()
    assert not np.isnan(want).any() and got.shape == (256, 256)
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_against_the_pallas_kernel(monkeypatch):
    # seekr_tpu's count goes through its Pallas kernel, in interpret mode
    monkeypatch.setenv("SEEKR_TPU_COUNT_IMPL", "pallas")
    bases, lengths = batch(40, 300, 4, seed=3)
    want = np.asarray(JaxPipeline(k=4, log2="Log2.pre").forward(bases, lengths))
    got = SeekrPipeline(k=4, log2="Log2.pre", device="cpu").forward(bases, lengths).numpy()
    assert not np.isnan(want).any()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("log2", ["Log2.pre", "Log2.post", "Log2.none"])
def test_counts_with_and_without_vectors(log2):
    bases, lengths = batch(48, 400, 3, seed=5)
    jp, tp = JaxPipeline(k=3, log2=log2), SeekrPipeline(k=3, log2=log2, device="cpu")
    want, w_mean, w_std = jp.counts(bases, lengths)
    got, g_mean, g_std = tp.counts(bases, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(g_mean.numpy(), np.asarray(w_mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g_std.numpy(), np.asarray(w_std), rtol=1e-6, atol=1e-6)
    # provided float64 vectors are cast to float32, not promoted to
    mean64 = np.asarray(w_mean, np.float64) + 0.5
    std64 = np.asarray(w_std, np.float64) * 2
    want2, _, _ = jp.counts(bases, lengths, mean=mean64, std=std64)
    got2, _, _ = tp.counts(bases, lengths, mean=mean64, std=std64)
    assert got2.dtype == torch.float32
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **TOL)
    got3, _, _ = tp.counts(bases, lengths, flat=False)
    assert got3.dim() == 3 and torch.equal(got3.reshape(48, -1), got)


def test_pipeline_rejects_bad_log2():
    with pytest.raises(ValueError, match="log2 must be one of"):
        SeekrPipeline(log2="log2", device="cpu")


FASTAS = ["data/example.fa", "data/example2.fa", "data/v22_pc_head.fa", "seqs1.fa"]


@pytest.mark.parametrize("fasta", FASTAS)
@pytest.mark.parametrize("k", [2, 4])
def test_kmer_counter_matches_fixtures(fasta, k):
    fa = str(FIXTURES / fasta)
    want = JaxCounter(fa, k=k, silent=True).get_counts()
    counter = KmerCounter(fa, k=k, silent=True, device="cpu")
    got = counter.get_counts()
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    assert counter.mean.shape == (4 ** k,) and counter.std.shape == (4 ** k,)
    np.testing.assert_allclose(pearson(got, got, device="cpu"), jax_pearson(want, want),
                               rtol=0, atol=1e-4, equal_nan=True)


def test_kmer_counter_reference_goldens():
    # the reference's own artifacts, as tests/test_parity_golden.py reads them
    data = FIXTURES / "data"
    fa = str(data / "example.fa")
    got = BasicCounter(fa, k=2, silent=True, device="cpu").get_counts()
    np.testing.assert_allclose(got, np.load(data / "example_2mers_counts.npy"),
                               rtol=1e-4, atol=1e-5)
    norm = KmerCounter(fa, k=2, log2="Log2.none", silent=True, device="cpu")
    norm.get_counts()
    np.testing.assert_allclose(norm.mean, np.load(data / "example_mean.npy"), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(norm.std, np.load(data / "example_std.npy"), rtol=1e-4, atol=1e-5)
    pre = KmerCounter(fa, k=2, mean=str(data / "example_mean.npy"),
                      std=str(data / "example_std.npy"), silent=True, device="cpu")
    np.testing.assert_allclose(pre.get_counts(), np.load(data / "example_2mers_count.npy"),
                               rtol=1e-4, atol=1e-5)


def test_long_sequence_path_matches(monkeypatch, tmp_path):
    import seekr_tpu.models.counter as jax_counter_mod

    monkeypatch.setattr(jax_counter_mod, "_LONG_SEQ_THRESHOLD", 1000)
    monkeypatch.setattr(counter_mod, "_LONG_SEQ_THRESHOLD", 1000)
    rng = np.random.default_rng(4)
    letters = np.array(list("AGTCN"))
    lengths = [300, 2500, 90, 700, 5001, 1000, 3]
    fa = tmp_path / "long.fa"
    fa.write_text("".join(f">s{i}\n{''.join(letters[rng.integers(0, 5, size=n)])}\n"
                          for i, n in enumerate(lengths)))
    raw = dict(k=3, mean=False, std=False, log2="Log2.none", silent=True)
    jc = JaxCounter(str(fa), outfile=str(tmp_path / "jax.npy"), **raw)
    tc = KmerCounter(str(fa), outfile=str(tmp_path / "torch.npy"), device="cpu", **raw)
    want = jc.make_count_file()
    got = tc.make_count_file()
    np.testing.assert_array_equal(got, want)
    # the saved artifacts are byte-identical
    assert (tmp_path / "jax.npy").read_bytes() == (tmp_path / "torch.npy").read_bytes()


def test_manual_seqs_and_tiny_rows():
    seqs = ["ACGTACGTAC", "AC", "", "NNNNACGT", "acgtACGTAA"]
    counter = KmerCounter(k=3, mean=False, std=False, log2="Log2.none", device="cpu",
                          silent=True)
    counter.seqs = seqs
    jc = JaxCounter(k=3, mean=False, std=False, log2="Log2.none", silent=True)
    jc.seqs = seqs
    np.testing.assert_array_equal(counter.get_counts(), jc.get_counts())
    row = [0.0] * 64
    counter.occurrences(row, "AAAA")
    assert row[0] == 1000.0


def test_get_counts_device_keeps_a_tensor():
    fa = str(FIXTURES / "data" / "example2.fa")
    counter = KmerCounter(fa, k=2, silent=True, device="cpu")
    dev = counter.get_counts_device()
    assert isinstance(dev, torch.Tensor) and counter.counts is None
    np.testing.assert_allclose(dev.numpy(), JaxCounter(fa, k=2, silent=True).get_counts(), **TOL)


def test_counter_argument_errors(tmp_path):
    fa = tmp_path / "one.fa"
    fa.write_text(">a\nACGTACGT\n")
    with pytest.raises(ValueError, match="single sequence"):
        KmerCounter(str(fa), device="cpu")
    with pytest.raises(ValueError, match="log2 must be one of"):
        KmerCounter(log2="x", device="cpu")
    c = KmerCounter(str(fa), outfile=str(tmp_path / "c.csv"), k=2, std=False,
                    binary=False, silent=True, device="cpu")
    with pytest.raises(NotImplementedError, match="CLI slice"):
        c.make_count_file()


def test_progress_bar_when_not_silent(capsys):
    fa = str(FIXTURES / "data" / "example.fa")
    got = KmerCounter(fa, k=2, device="cpu").get_counts()
    assert "Kmers" in capsys.readouterr().err
    np.testing.assert_allclose(got, JaxCounter(fa, k=2, silent=True).get_counts(), **TOL)
