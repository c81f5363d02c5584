"""The port's sliding-window domain Pearson (``models/domain.py``) and its
``domain_pearson`` command against seekr_tpu's, on the CPU.

Sequences are made from a seed with numpy.  Tolerances: r atol 1e-4 (the two
packages' float32 GEMMs differ in the last bits); percentiles equal except
for windows whose r lies within 1e-5 of a reference r of the same query;
window labels, tiling and percentile semantics exact.
"""

import numpy as np
import pandas as pd
import pytest
from scipy import stats as scipy_stats

from seekr_tpu.models.domain import DomainPearson as JaxDomainPearson
from seekr_tpu_torch import cli
from seekr_tpu_torch.io.fast_csv import read_labeled_csv
from seekr_tpu_torch.models.domain import DomainPearson, percentile_of_scores, tile_windows


def rand_seq(rng, n):
    return "".join(np.array(list("AGTC"))[rng.integers(0, 4, size=n)])


@pytest.fixture
def fastas(tmp_path):
    rng = np.random.default_rng(1)
    (tmp_path / "q.fa").write_text(f">Q0|x\n{rand_seq(rng, 300)}\n>Q1|y\n{rand_seq(rng, 450)}\n")
    # two targets share the short name 'A'; 'B' is shorter than a window
    (tmp_path / "t.fa").write_text(f">A|one\n{rand_seq(rng, 700)}\n>A|two\n{rand_seq(rng, 260)}\n"
                                   f">B\n{rand_seq(rng, 90)}\n>C|z\n{rand_seq(rng, 520)}\n")
    (tmp_path / "r.fa").write_text("".join(f">R{i}\n{rand_seq(rng, 400)}\n" for i in range(12)))
    return {name: str(tmp_path / f"{name}.fa") for name in ("q", "t", "r")}


def near_ties(r, null, tol=1e-5):
    out = np.zeros(r.shape, dtype=bool)
    for j in range(r.shape[1]):
        b = np.sort(null[j])
        out[:, j] = (np.searchsorted(b, r[:, j] + tol, side="right")
                     > np.searchsorted(b, r[:, j] - tol, side="left"))
    return out


def test_tile_windows_geometry():
    assert [t[0] for t in tile_windows("A" * 10, window=4, slide=3)] == [0, 3, 6]
    assert [t[0] for t in tile_windows("A" * 11, window=4, slide=3)] == [0, 3, 6]
    assert tile_windows("AGT", window=4, slide=3) == [(0, "AGT")]
    assert tile_windows("AGTC", window=4, slide=3) == [(0, "AGTC")]
    for window, slide in ((0, 1), (4, 0)):
        with pytest.raises(ValueError):
            tile_windows("AGTC", window=window, slide=slide)


def test_percentile_of_scores_is_scipy_mean_kind_with_nan_rules():
    rng = np.random.default_rng(0)
    null = rng.normal(size=200)
    null[10:20] = null[0]  # ties
    scores = np.concatenate([rng.normal(size=50), null[:5], [null.min() - 1, null.max() + 1]])
    want = [scipy_stats.percentileofscore(null, s, kind="mean") for s in scores]
    np.testing.assert_allclose(percentile_of_scores(null, scores), want, rtol=1e-12)
    # a NaN score is a NaN percentile; NaN null entries are left out
    got = percentile_of_scores(np.array([0.1, np.nan, 0.3]), np.array([np.nan, 0.2]))
    assert np.isnan(got[0]) and got[1] == 50.0


@pytest.mark.parametrize("log2", ["Log2.post", "Log2.pre", "Log2.none"])
def test_r_and_percentiles_match_seekr_tpu(fastas, log2):
    kwargs = dict(k=3, window=200, slide=50, log2=log2)
    jax = JaxDomainPearson(fastas["q"], fastas["t"], fastas["r"], **kwargs)
    want = jax.run()
    port = DomainPearson(fastas["q"], fastas["t"], fastas["r"], device="cpu", **kwargs)
    got = port.run()
    assert got.index == list(want.index) == port.window_labels
    assert got.columns == list(want.columns) == ["Q0", "Q1"]
    np.testing.assert_allclose(got.values, want.to_numpy(), rtol=0, atol=1e-4)
    ties = near_ties(got.values, _reference_r(port))
    assert np.array_equal(port.percentiles.values[~ties],
                          jax.percentiles.to_numpy()[~ties])
    assert port.percentiles.values.dtype == jax.percentiles.to_numpy().dtype


def _reference_r(dom):
    """Each query's r against the reference sequences, by the port's own path."""
    from seekr_tpu_torch.io.fasta import Reader
    from seekr_tpu_torch.models.pearson import pearson
    from seekr_tpu_torch.ops.normalize import normalize_counts

    q = dom._raw_for(Reader(dom.query_path).get_seqs())
    ref = dom._raw_for(Reader(dom.reference_path).get_seqs())
    ref_n, mean, std = normalize_counts(ref, log2_mode=dom.log2)
    return pearson(dom._normalized(q, mean, std), ref_n, device="cpu").astype(np.float64)


def test_window_labels_deduplicate_short_names(fastas):
    dom = DomainPearson(fastas["q"], fastas["t"], k=2, window=200, slide=100, device="cpu")
    dom.split_targets()
    assert dom.target_names == ["A", "A.1", "B", "C"]
    assert dom.window_labels == ["A|0", "A|100", "A|200", "A|300", "A|400", "A|500",
                                 "A.1|0", "B|0", "C|0", "C|100", "C|200", "C|300"]
    assert len(set(dom.window_labels)) == len(dom.window_labels)


def test_nan_windows_and_no_reference(tmp_path, fastas):
    # an all-N window has no k-mer: raw, its profile is constant, its r NaN,
    # and so is its percentile
    rng = np.random.default_rng(2)
    (tmp_path / "tn.fa").write_text(f">N\n{'N' * 150}\n>T\n{rand_seq(rng, 300)}\n")
    dom = DomainPearson(fastas["q"], str(tmp_path / "tn.fa"), fastas["r"], k=2,
                        window=200, slide=100, mean=False, std=False, log2="Log2.none",
                        device="cpu")
    dom.run()
    assert np.isnan(dom.r_values.values[0]).all() and np.isnan(dom.percentiles.values[0]).all()
    assert not np.isnan(dom.percentiles.values[1:]).any()
    plain = DomainPearson(fastas["q"], fastas["t"], k=2, window=200, slide=100,
                          device="cpu")
    plain.run()
    assert plain.percentiles is None and plain.r_values.shape == (12, 2)


def test_single_window_basis_with_computed_std_raises(tmp_path, fastas):
    (tmp_path / "one.fa").write_text(">only\nACGTACGTAC\n")
    dom = DomainPearson(fastas["q"], str(tmp_path / "one.fa"), k=2, window=100, slide=10,
                        device="cpu")
    with pytest.raises(ValueError, match="single sequence"):
        dom.run()


def test_percentiles_path_without_reference_warns(tmp_path, fastas, capsys):
    DomainPearson(fastas["q"], fastas["t"], k=2, window=200, slide=100,
                  percentiles_path=str(tmp_path / "p.csv"), device="cpu").run()
    assert "without --reference" in capsys.readouterr().out
    assert not (tmp_path / "p.csv").exists()


def test_explicit_vectors_and_artifacts_match_seekr_tpu_bytes(tmp_path, fastas):
    rng = np.random.default_rng(3)
    np.save(tmp_path / "mean.npy", rng.uniform(10, 20, 64))
    np.save(tmp_path / "std.npy", rng.uniform(3, 6, 64))
    kwargs = dict(mean=str(tmp_path / "mean.npy"), std=str(tmp_path / "std.npy"), k=3,
                  window=200, slide=50)
    jax = JaxDomainPearson(fastas["q"], fastas["t"], fastas["r"],
                           r_values_path=str(tmp_path / "j_r.csv"),
                           percentiles_path=str(tmp_path / "j_p.csv"), **kwargs)
    jax.run()
    port = DomainPearson(fastas["q"], fastas["t"], fastas["r"],
                         r_values_path=str(tmp_path / "t_r.csv"),
                         percentiles_path=str(tmp_path / "t_p.csv"), device="cpu", **kwargs)
    port.run()
    t, j = pd.read_csv(tmp_path / "t_r.csv", index_col=0), pd.read_csv(tmp_path / "j_r.csv",
                                                                        index_col=0)
    assert list(t.index) == list(j.index) and list(t.columns) == list(j.columns)
    np.testing.assert_allclose(t.to_numpy(), j.to_numpy(), rtol=0, atol=1e-4)
    # the writer on one matrix: seekr_tpu's frame through the port's writer
    from seekr_tpu_torch.io.fast_csv import LabeledMatrix

    LabeledMatrix(jax.percentiles.to_numpy(), jax.percentiles.index,
                  jax.percentiles.columns).to_csv(tmp_path / "x.csv")
    assert (tmp_path / "x.csv").read_bytes() == (tmp_path / "j_p.csv").read_bytes()


def test_domain_pearson_command(tmp_path, monkeypatch, fastas):
    from seekr_tpu import cli as jax_cli

    monkeypatch.chdir(tmp_path)
    args = [fastas["q"], fastas["t"], "-r", fastas["r"], "-k", "3", "-w", "200", "-sl", "50"]
    cli.main(["domain_pearson", *args, "-rp", "t_r.csv", "-pp", "t_p.csv", "--device", "cpu"])
    jax_cli.main(["domain_pearson", *args, "-rp", "j_r.csv", "-pp", "j_p.csv"])
    got, want = read_labeled_csv("t_r.csv"), pd.read_csv("j_r.csv", index_col=0)
    assert got.index == list(want.index) and got.columns == list(want.columns)
    np.testing.assert_allclose(got.values, want.to_numpy(), rtol=0, atol=1e-4)
    assert read_labeled_csv("t_p.csv").shape == got.shape
