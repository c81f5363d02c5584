"""The port's reference-layout aliases: ``s/seekr/seekr_tpu_torch/`` must work.

Each alias module exposes the surface of seekr_tpu's alias of the same name
(``tests/test_reference_layout_aliases.py``), as the port's canonical objects;
where the name is also a package-root export, the module is callable, so the
function and module idioms coexist in one process.
"""

import importlib

import numpy as np
import pytest

SURFACE = {
    "fasta": ["Downloader"],
    "fasta_reader": ["Reader"],
    "kmer_counts": ["BasicCounter", "Log2"],
    "pearson": ["pearson"],
    "find_dist": ["find_dist"],
    "find_pval": ["find_pval", "is_float_type", "check_tuple_format", "check_main_list"],
    "adj_pval": ["adj_pval", "is_symmetric"],
    "filter_gencode": ["filter_gencode"],
    "kmer_heatmap": ["kmer_heatmap", "is_hex_color", "check_hex_colors"],
    "kmer_dendrogram": ["kmer_dendrogram"],
    "kmer_count_barplot": ["kmer_count_barplot"],
    "kmer_msd_barplot": ["kmer_msd_barplot"],
    "kmer_comp_textplot": ["kmer_comp_textplot", "find_word_coordinates", "ass_color"],
    "kmer_indi_textplot": ["kmer_indi_textplot", "find_word_coordinates", "ass_color"],
    "kmer_leiden": ["kmer_leiden"],
    "my_tqdm": ["my_tqdm", "my_trange"],
}


@pytest.mark.parametrize("name", sorted(SURFACE))
def test_alias_exposes_seekr_tpus_surface_as_the_canonical_objects(name):
    ours = importlib.import_module(f"seekr_tpu_torch.{name}")
    theirs = importlib.import_module(f"seekr_tpu.{name}")
    assert sorted(ours.__all__) == sorted(theirs.__all__)
    for attr in SURFACE[name]:
        got = getattr(ours, attr)
        assert got.__module__.startswith("seekr_tpu_torch."), (name, attr)
        assert got.__qualname__ == getattr(theirs, attr).__qualname__
        canonical = importlib.import_module(got.__module__)
        assert getattr(canonical, attr) is got
    root_export = name in __import__("seekr_tpu_torch")._LAZY_EXPORTS
    assert callable(ours) == root_export


def test_function_and_module_idioms_coexist():
    import seekr_tpu_torch.pearson  # noqa: F401  (rebinds seekr_tpu_torch.pearson)
    import seekr_tpu_torch
    from seekr_tpu_torch.models.pearson import pearson as canonical

    a = np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32)
    fn = seekr_tpu_torch.pearson  # the module now, callable
    np.testing.assert_array_equal(fn(a, a, device="cpu"), canonical(a, a, device="cpu"))
    from seekr_tpu_torch.pearson import pearson

    assert pearson is canonical
    import seekr_tpu_torch.kmer_heatmap  # noqa: F401
    from seekr_tpu_torch.viz.kmer_heatmap import kmer_heatmap

    assert seekr_tpu_torch.kmer_heatmap.kmer_heatmap is kmer_heatmap
    assert callable(seekr_tpu_torch.kmer_heatmap)


def test_root_exports_the_plots_lazily():
    import seekr_tpu_torch
    from seekr_tpu_torch.viz import kmer_indi_textplot

    # the attribute itself may be the alias module once that is imported
    assert seekr_tpu_torch.__getattr__("kmer_indi_textplot") is kmer_indi_textplot
    assert {"kmer_heatmap", "kmer_dendrogram", "kmer_count_barplot", "kmer_msd_barplot",
            "kmer_comp_textplot", "kmer_indi_textplot"} <= set(seekr_tpu_torch.__all__)
