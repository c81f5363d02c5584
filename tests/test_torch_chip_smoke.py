"""Rehearsal of chip_smoke.py on the CPU.

Every phase runs at a tiny scale with ``device="cpu"``: the port's plain
versions stand in for the kernels, and the kernel comparisons and timings are
skipped (they need the card).  ``main()`` itself must refuse to run without a
CUDA card, and the script alone, without the package beside it, must fail.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_phases_rehearse_on_cpu():
    state = chip_smoke.run(torch.device("cpu"), chip_smoke.TINY, seed=0)
    m = chip_smoke.TINY.corpus_m
    assert state["sim"].shape == (m, m)
    assert len(state["large_k_seqs"]) == chip_smoke.TINY.large_k_m
    # no kernel runs on the CPU, and no launch is counted
    assert state["launches"] == {"count_kmers_smem": 0, "count_kmers_hiblocked": 0}
    # phase 6 ran the statistics chain, CLI included, and held its checks
    stats = state["stats"]
    assert stats["background_values"] == chip_smoke.TINY.stats_subset
    assert stats["r_max_abs_vs_f64"] <= 1e-4 and stats["adj_max_abs_vs_direct_bh"] <= 1e-12
    assert stats["pairs_max_abs_vs_blocked"] <= 1e-5
    # phase 7 served the corpus, grew it across the quantum and held its checks
    served = state["serve"]
    assert served["resident_rows"] == 256 and served["resident_rows_after_growth"] == 512
    assert served["segmented_bitwise"] and served["grow_within_bitwise"]
    assert served["snapshot_bitwise"] and served["socket_equals_in_process"]
    assert served["burst"]["answered"] == 8
    # phase 8 found the planted families, dense and streamed, and the native
    # host paths of phases 4 and 6 held against the Python ones
    found = state["leiden"]
    assert found["recovers_families"] and found["streamed_same_partition"]
    assert found["families_found"] == chip_smoke.TINY.leiden_families
    assert stats["adj_pval_bitwise_numpy"] and stats["pvals_csv_bytes_equal_python"]
    assert stats["ecdf_cell_device_bitwise_host"]
    # phase 9 ran the workflow, the streamed correction, domain_pearson, pwms,
    # the data tools and the doctor, and held every check
    wf = state["workflow"]
    assert wf["checks"] and all(wf["checks"].values())
    assert wf["families_found"] == chip_smoke.TINY.wf_families
    assert len(wf["adj_pval_bi"]) == 6 and wf["adj_pval_bi"][0]["stream_symmetric"]
    assert wf["adj_pval_bi"][-1]["max_bucket_pairs"] == chip_smoke.TINY.adj_tie_cap
    assert wf["doctor_rc"] == 0 and wf["domain_windows"] > chip_smoke.TINY.dom_targets
    # phase 10 clustered, counted, scanned, streamed, printed help, drew
    plots = state["plots"]
    assert plots["checks"] and all(plots["checks"].values())
    assert plots["pdist_forced_to_device"] and plots["help_sections"] == 25
    assert plots["column_linkage_rows"] == 4 ** chip_smoke.TINY.leiden_k - 1
    assert len(plots["drawing"]["drawn"]) + len(plots["drawing"]["raised"]) == 10
    # phase 11 ran the mesh paths on four CPU shards and held every check
    mesh = state["mesh"]
    assert mesh["checks"] and all(mesh["checks"].values())
    assert (mesh["cards"], mesh["shards"]) == (0, 4) and mesh["cli_dp"] == "-dp 4 ran"
    assert mesh["kmer_axis"]["k"] == 9 and mesh["long_sequence"]["bases"] == 20_000
    # phase 12 ran the mesh across two CPU processes and held every check
    procs = state["processes"]
    assert procs["checks"] and all(procs["checks"].values())
    assert procs["backends"] == {"control": "gloo", "data": "gloo"}
    assert procs["killed_follower"]["leader_rc"] == 0


@pytest.mark.parametrize("visible, want", [(None, ["0", "1"]), ("4,5,6,7", ["4", "5"]),
                                            ("GPU-a, GPU-b", ["GPU-a", "GPU-b"])])
def test_child_env_puts_each_process_on_its_own_visible_card(monkeypatch, visible, want):
    # with a card each, process pid gets the pid-th card this process may use
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    got = [chip_smoke.child_env(pid, 4)["CUDA_VISIBLE_DEVICES"] for pid in range(2)]
    assert got == want
    # one card: both processes share it, under the parent's own setting
    shared = chip_smoke.child_env(1, 1)
    assert shared.get("CUDA_VISIBLE_DEVICES") == visible
    assert shared["PYTHONPATH"] == str(ROOT)


def test_direct_bh_is_benjamini_hochberg():
    p = np.array([0.01, 0.04, 0.03, 0.2, 0.04])
    # p * n / rank, then the running minimum from the largest rank down
    np.testing.assert_allclose(chip_smoke.direct_bh(p), [0.05, 0.05, 0.05, 0.2, 0.05])


def test_near_background():
    bkg = np.array([0.1, 0.2, 0.2000001])
    r = np.array([0.10000002, 0.15, 0.2])
    assert chip_smoke.near_background(r, bkg).tolist() == [True, False, True]
    assert chip_smoke.near_background(r, bkg, count=True).tolist() == [1, 0, 2]


def test_family_corpus_and_partition_helpers():
    seqs, truth = chip_smoke.family_corpus(3, 4, 1024, seed=5)
    again, _ = chip_smoke.family_corpus(3, 4, 1024, seed=5)
    assert seqs == again and len(seqs) == 12 and truth.tolist() == [0] * 4 + [1] * 4 + [2] * 4
    for f in range(3):  # each member differs from its founder's length-mates in ~10%
        a, b = seqs[4 * f], seqs[4 * f + 1]
        assert len(a) == len(b) and 200 <= len(a) <= 1024
        assert 0.1 < np.mean(np.frombuffer(a.encode(), np.uint8)
                             != np.frombuffer(b.encode(), np.uint8)) < 0.3
    assert chip_smoke.same_partition([0, 0, 1, 2], [5, 5, 3, 4])
    assert not chip_smoke.same_partition([0, 0, 1, 1], [0, 1, 1, 1])
    assert chip_smoke.adjusted_rand_index([0, 0, 1, 1], [1, 1, 0, 0]) == 1.0
    assert chip_smoke.adjusted_rand_index([0, 0, 1, 1], [0, 1, 0, 1]) < 0
    m = np.array([[1.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.0]])
    assert chip_smoke.edge_pairs(m, 0.2).tolist() == [1, 5]


def test_corpus_is_seeded_and_shaped():
    b1, n1 = chip_smoke.make_corpus(50, 4096, seed=3)
    b2, n2 = chip_smoke.make_corpus(50, 4096, seed=3)
    assert np.array_equal(b1, b2) and np.array_equal(n1, n2)
    assert b1.shape == (50, 4096) and b1.dtype == np.int8
    assert n1.min() >= 200 and n1.max() <= 4096
    assert (b1[np.arange(4096)[None, :] >= n1[:, None]] == 4).all()


@pytest.mark.parametrize("k", range(8, 16))
def test_slice_edge_row_hits_both_edges_of_every_slice_width(k):
    from seekr_tpu_torch.ops.count import window_codes
    from seekr_tpu_torch.ops.count_cuda import hiblock_plan

    lpad = 4096
    row = chip_smoke.slice_edge_row(np.random.default_rng(k), k, lpad)
    code, valid = window_codes(torch.from_numpy(row[None]), torch.tensor([lpad]), k)
    hit = set(code[valid].tolist())
    s = hiblock_plan(k)[0]
    assert {0, s - 1, s, 2 * s - 1, 2 * s, 4 ** k - s - 1, 4 ** k - s, 4 ** k - 1} <= hit


def test_kernel_case_at_one_row():
    b, n = chip_smoke.kernel_case(np.random.default_rng(0), 1, 600, 15)
    assert b.shape == (1, 600) and n.tolist() == [600]


def test_topk_agrees_allows_swaps_only_at_near_ties():
    ref_vals = np.array([[0.9, 0.5, 0.5000005, 0.1]])  # k = 3 and the 4th value
    ref_idx = np.array([[4, 7, 2, 9]])
    got_vals = ref_vals[:, :3] + 1e-7
    assert chip_smoke.topk_agrees(got_vals, np.array([[4, 2, 7]]), ref_vals, ref_idx)
    assert not chip_smoke.topk_agrees(got_vals, np.array([[7, 4, 2]]), ref_vals, ref_idx)
    assert not chip_smoke.topk_agrees(got_vals + 1e-5, ref_idx[:, :3], ref_vals, ref_idx)


def test_needed_bytes():
    # rows with no window move no digits; every row writes its output row
    got = chip_smoke._needed_bytes(np.array([0, 5, 100, 9000]), 4096, 6)
    assert got == (100 + 4096) + 4 * 4 + 4 * 4 * 4096


def test_main_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def test_script_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_pwm_weights_helper_is_the_counts_weighter_rule():
    from seekr_tpu_torch.models.pwm import CountsWeighter

    rng = np.random.default_rng(3)
    for table in chip_smoke.random_pwms(rng, 3, lengths=(2, 6)):
        pwm = {b: dict(enumerate(table[:, c])) for b, c in zip("ACGT", range(4))}
        weights = CountsWeighter(k=4).build_weights_dict(pwm)
        want = [weights[km] for km in CountsWeighter(k=4).kmers]
        np.testing.assert_allclose(chip_smoke.pwm_weights(table, 4), want, rtol=1e-12)


def test_gencode_corpus_is_seeded_and_gencode_shaped():
    seqs = ["ACGT" * (i + 50) for i in range(30)]
    h1, gtf1, facts = chip_smoke.gencode_corpus(seqs, np.random.default_rng(4))
    h2, gtf2, _ = chip_smoke.gencode_corpus(seqs, np.random.default_rng(4))
    assert h1 == h2 and gtf1 == gtf2 and len(facts) == 30
    for header, seq, (n, _, number, name) in zip(h1, seqs, facts):
        fields = header.split("|")
        assert int(fields[-2]) == len(seq) == n and fields[4] == name
        assert name.endswith(f"-{number}") and len(number) == 3
    assert gtf1.count("\ttranscript\t") == 30 and gtf1.count("\texon\t") == 30


def test_plot_phase_helpers():
    # an order sorted up to the tolerance, and one with an inversion past it
    keys = np.array([0.1, 0.3, 0.3000001, 0.2])
    assert chip_smoke.order_within([0, 3, 2, 1], keys, True, 1e-5)
    assert not chip_smoke.order_within([0, 1, 3, 2], keys, True, 1e-5)
    assert chip_smoke.order_within([1, 2, 3, 0], keys, False, 1e-5)
    assert chip_smoke.word_scan("AAAAT", "AA") == [0, 1, 2, 3]
    assert chip_smoke.word_scan("ACGT", "GTA") == [] and chip_smoke.word_scan("A", "AC") == []
    from scipy.spatial.distance import pdist

    x = np.random.default_rng(0).normal(size=(12, 8))
    d = pdist(x, "correlation")
    agree = chip_smoke.leaf_agreement(d.astype(np.float32).astype(np.float64), d, "complete")
    assert agree["holds"] and agree["equal_leaf_share"] == 1.0
    err = chip_smoke.condensed_err(np.array([0.5, np.nan, 0.25 + 2e-5]),
                                   np.array([[0, 0.5, np.nan], [0.5, 0, 0.25],
                                             [np.nan, 0.25, 0]]))
    assert err["same_nan"] and err["within_rtol_1e-4_atol_1e-5"]
    assert abs(err["max_abs"] - 2e-5) < 1e-12


def test_data_parallel_on_shards_resolves_to_one_device_and_restores():
    from seekr_tpu_torch.parallel import mesh as mesh_mod

    real = mesh_mod.build_mesh_from_flags
    with chip_smoke.data_parallel_on_shards(1):
        mesh = mesh_mod.build_mesh_from_flags(4, device=torch.device("cpu"))
        assert mesh.devices.shape == (4, 1) and mesh_mod.build_mesh_from_flags(None) is None
        assert mesh_mod.build_mesh_from_flags(None, 2, device="cpu").devices.shape == (1, 2)
    assert mesh_mod.build_mesh_from_flags is real
    with chip_smoke.data_parallel_on_shards(4):  # enough cards: the library's own rule
        assert mesh_mod.build_mesh_from_flags is real
    assert chip_smoke.mesh_devices(torch.device("cpu")) == ([torch.device("cpu")] * 4, 0)
