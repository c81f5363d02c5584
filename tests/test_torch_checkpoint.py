"""Sharded checkpoints of the port (``seekr_tpu_torch.io.checkpoint``) on a mesh of
CPU shards: the values round-trip bitwise, onto the same spec and onto another
mesh, as ``tests/test_checkpoint.py`` holds seekr_tpu's orbax checkpoints; the
vector artifacts are seekr_tpu's bytes."""

import os

import numpy as np
import pytest
import torch

from seekr_tpu_torch.io.checkpoint import load_sharded, save_pipeline_state, save_sharded
from seekr_tpu_torch.parallel.mesh import (data_sharding, make_mesh, replicated,
                                           row_col_sharding, shard)

CPU = torch.device("cpu")


def meshes():
    return make_mesh([CPU] * 8), make_mesh([CPU] * 8, kmer_parallel=2)


def test_roundtrip_same_sharding(tmp_path):
    rows, _ = meshes()
    x = np.arange(16 * 32, dtype=np.float32).reshape(16, 32)
    save_sharded(str(tmp_path / "ckpt"), shard(x, data_sharding(rows)))
    # one file per distinct shard and the index
    assert len(os.listdir(tmp_path / "ckpt")) == 9
    restored = load_sharded(str(tmp_path / "ckpt"), sharding=data_sharding(rows),
                            shape=x.shape, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(restored), x)
    assert restored.sharding == data_sharding(rows)
    assert [tuple(s.data.shape) for s in restored.shards] == [(2, 32)] * 8


@pytest.mark.parametrize("direction", ["rows_to_grid", "grid_to_rows"])
def test_save_restore_resharded(tmp_path, direction):
    rows, grid = meshes()
    src, dst = ((data_sharding(rows), row_col_sharding(grid)) if direction == "rows_to_grid"
                else (row_col_sharding(grid), data_sharding(rows)))
    x = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
    save_sharded(str(tmp_path / "c"), shard(x, src))
    restored = load_sharded(str(tmp_path / "c"), sharding=dst, shape=x.shape,
                            dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(restored), x)
    assert restored.sharding == dst
    want = (2, 32) if direction == "rows_to_grid" else (1, 64)
    assert tuple(restored.shards[0].data.shape) == want


def test_restore_reads_only_the_ranges_a_shard_needs(tmp_path, monkeypatch):
    rows, grid = meshes()
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    save_sharded(str(tmp_path / "c"), shard(x, data_sharding(rows)))
    opened = []
    load = np.load

    def spy(path, *args, **kwargs):
        opened.append((os.path.basename(path), kwargs.get("mmap_mode")))
        return load(path, *args, **kwargs)

    monkeypatch.setattr(np, "load", spy)
    restored = load_sharded(str(tmp_path / "c"), sharding=row_col_sharding(grid))
    # 4 data rows of 2 saved shards each, read once per distinct target shard
    # (8 targets: each column half reads its row's 2 files), memory-mapped
    assert len(opened) == 16 and all(mode == "r" for _, mode in opened)
    np.testing.assert_array_equal(np.asarray(restored), x)
    with pytest.raises(ValueError, match="holds shape"):
        load_sharded(str(tmp_path / "c"), sharding=row_col_sharding(grid), shape=(4, 4))


def test_save_pipeline_state_artifacts(tmp_path):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from seekr_tpu.io.checkpoint import save_pipeline_state as jax_save_pipeline_state
    from seekr_tpu.parallel.mesh import make_mesh as jax_make_mesh

    rows, _ = meshes()
    counts = shard(np.ones((8, 16), np.float32), data_sharding(rows))
    mean = np.linspace(0, 1, 16, dtype=np.float32)
    std = torch.ones(16)
    save_pipeline_state(str(tmp_path / "port"), counts=counts, mean=mean, std=std,
                        sim=shard(np.eye(8, dtype=np.float32), replicated(rows)))
    jax_counts = jax.device_put(np.ones((8, 16), np.float32),
                                NamedSharding(jax_make_mesh(jax.devices()[:8]),
                                              P("data", None)))
    jax_save_pipeline_state(str(tmp_path / "jax"), counts=jax_counts, mean=mean,
                            std=std.numpy())
    for name in ("mean.npy", "std.npy"):  # reference-compatible plain .npy artifacts
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    np.testing.assert_array_equal(load_sharded(str(tmp_path / "port" / "counts")),
                                  np.ones((8, 16)))
    np.testing.assert_array_equal(load_sharded(str(tmp_path / "port" / "pearson")), np.eye(8))


def test_relative_path_and_overwrite(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    x = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    save_sharded("rel_ckpt", x)
    np.testing.assert_array_equal(load_sharded("rel_ckpt"), x.numpy())
    save_sharded("rel_ckpt", np.arange(6.0) * 2)  # a rerun overwrites its checkpoint
    np.testing.assert_array_equal(load_sharded("rel_ckpt"), np.arange(6.0) * 2)
    assert sorted(os.listdir(tmp_path)) == ["rel_ckpt"]
