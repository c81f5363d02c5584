"""The port's PWM weighting (``models/pwm.CountsWeighter``) and its ``pwms``
command against seekr_tpu's, on the CPU, with the fixture PWM
``tests/fixtures/pwms/SYN1_0.6.txt`` and counts made from a seed with numpy.

Tolerances: the PWM tables and the k-mer weights equal; the scores within
1e-9 relative, and in fact byte-equal in the CSV (the same float64 product on
the same layout); the weights also held to a loop written apart.
"""

import itertools
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from seekr_tpu.models.pwm import CountsWeighter as JaxCountsWeighter
from seekr_tpu_torch import cli
from seekr_tpu_torch.io.fast_csv import LabeledMatrix, read_labeled_csv
from seekr_tpu_torch.models.pwm import CountsWeighter

PWM_DIR = str(Path(__file__).resolve().parent / "fixtures" / "pwms")


def oracle_weights(k):
    """k-mer weights against the fixture PWM, from its rows (ACGU columns)."""
    rows = np.loadtxt(Path(PWM_DIR) / "SYN1_0.6.txt", skiprows=1)[:, 1:]
    col = {"A": 0, "C": 1, "G": 2, "T": 3}
    n, w = rows.shape[0], min(k, rows.shape[0])
    out = {}
    for letters in itertools.product("AGTC", repeat=k):
        total = 0.0
        for s in range(k - w + 1):
            for start in range(n - w + 1):
                prod = 1.0
                for i, base in enumerate(letters[s:s + w]):
                    prod *= rows[start + i, col[base]]
                total += prod
        out["".join(letters)] = total
    return out


def test_pwm_tables_and_weights_equal_seekr_tpu():
    for k in (1, 2, 5, 8):  # 8: a motif shorter than k scores its sub-words
        port, jax = CountsWeighter(PWM_DIR, k=k), JaxCountsWeighter(PWM_DIR, k=k)
        (tp, tpwm), = list(port.gen_pwm_dicts())
        (jp, jpwm), = list(jax.gen_pwm_dicts())
        assert tp == jp and tpwm == jpwm and set(tpwm) == {"A", "C", "G", "T"}
        assert port.build_weights_dict(tpwm) == jax.build_weights_dict(jpwm)
        want = oracle_weights(k)
        got = port.build_weights_dict(tpwm)
        assert set(got) == set(want)
        np.testing.assert_allclose([got[km] for km in want], list(want.values()), rtol=1e-12)


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("form", ["ndarray", "npy", "csv", "frame", "labeled"])
def test_scores_and_csv_bytes_match_seekr_tpu(tmp_path, k, form):
    rng = np.random.default_rng(k)
    counts = rng.normal(0, 1, (6, 4 ** k)).astype(np.float32)
    kmers = CountsWeighter(k=k).kmers
    frame = pd.DataFrame(counts, index=[f"s{i}" for i in range(6)], columns=kmers)
    np.save(tmp_path / "c.npy", counts)
    frame.to_csv(tmp_path / "c.csv")
    given = {"ndarray": (counts, counts), "npy": (str(tmp_path / "c.npy"),) * 2,
             "csv": (str(tmp_path / "c.csv"),) * 2, "frame": (frame, frame),
             "labeled": (LabeledMatrix(counts, frame.index, kmers), frame)}[form]
    got = CountsWeighter(PWM_DIR, given[0], k=k, out_path=str(tmp_path / "t.csv")).run()
    want = JaxCountsWeighter(PWM_DIR, given[1], k=k, out_path=str(tmp_path / "j.csv")).run()
    assert got.index == list(want.index) == ["SYN1_0.6.txt"]
    assert got.columns == list(range(6)) and got.values.dtype == np.float64
    np.testing.assert_allclose(got.values, want.to_numpy(), rtol=1e-9, atol=0)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_scores_are_counts_times_weights():
    counts = np.arange(1.0, 33.0).reshape(2, 16)
    df = CountsWeighter(PWM_DIR, counts, k=2).run()
    want = oracle_weights(2)
    wvec = np.array([want[km] for km in CountsWeighter(k=2).kmers])
    np.testing.assert_allclose(df.values, (counts @ wvec)[None, :], rtol=1e-12)


def test_what_raises(tmp_path):
    with pytest.raises(ValueError, match="counts are required"):
        CountsWeighter(PWM_DIR, k=2).run()
    with pytest.raises(ValueError, match="pwm_dir is required"):
        next(CountsWeighter(k=2).gen_pwm_dicts())
    # counts of another k must fail loudly instead of scoring 0
    pd.DataFrame(np.ones((2, 16)), columns=CountsWeighter(k=2).kmers).to_csv(tmp_path / "c.csv")
    with pytest.raises(ValueError, match="do not match k=3"):
        CountsWeighter(PWM_DIR, str(tmp_path / "c.csv"), k=3).run()


def test_pwms_command(tmp_path, monkeypatch):
    from seekr_tpu import cli as jax_cli

    monkeypatch.chdir(tmp_path)
    np.save("c.npy", np.random.default_rng(9).random((4, 16)).astype(np.float32))
    cli.main(["pwms", PWM_DIR, "c.npy", "-k", "2", "-o", "t.csv", "--device", "cpu"])
    jax_cli.main(["pwms", PWM_DIR, "c.npy", "-k", "2", "-o", "j.csv"])
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert read_labeled_csv("t.csv").shape == (1, 4)
