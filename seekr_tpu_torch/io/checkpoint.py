"""Checkpoint and resume of sharded tensors, without orbax.

Port of ``seekr_tpu/io/checkpoint.py``.  The reference's checkpoints are its
file artifacts (counts, mean/std .npy), which the port writes byte for byte.
This module persists a *sharded* intermediate (a count matrix spread over a
mesh) without gathering it on one device, and restores it onto the same or
another mesh and spec.

The format is a directory: one ``.npy`` per distinct shard and ``index.json``
(global shape, dtype, each shard's file and its start/stop per dimension).
Restoring onto a sharding reads, for each target shard, only the ranges it
needs, through ``np.load(mmap_mode="r")``.  seekr_tpu's orbax checkpoints are
not read: the card's machine has no orbax.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

INDEX = "index.json"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _unique_shards(array):
    """The global shape, and (start/stop per dimension, host array) of each
    distinct piece."""
    from seekr_tpu_torch.parallel.mesh import ShardedTensor

    if isinstance(array, ShardedTensor):
        return array.shape, [([(sl.start, sl.stop) for sl in s.index], _host(s.data))
                             for s in array.unique_shards()]
    host = _host(array)
    return host.shape, [([(0, n) for n in host.shape], host)]


def save_sharded(path: str, array) -> None:
    """Save a ``ShardedTensor`` (one file per distinct shard), a tensor or an
    array.  A rerun overwrites: the new checkpoint is written beside the old one
    and replaces it only when complete."""
    path = os.path.abspath(path)
    shape, shards = _unique_shards(array)
    tmp = f"{path}.part"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    entries = []
    for n, (ranges, host) in enumerate(shards):
        name = f"shard_{n:05d}.npy"
        np.save(os.path.join(tmp, name), host)
        entries.append({"file": name, "start": [a for a, _ in ranges],
                        "stop": [b for _, b in ranges]})
    index = {"format": 1, "shape": [int(n) for n in shape], "dtype": str(shards[0][1].dtype),
             "shards": entries}
    with open(os.path.join(tmp, INDEX), "w") as fh:
        json.dump(index, fh)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _read_range(path, index, start, stop) -> np.ndarray:
    """The block [start, stop) of the saved array, from the saved shards that
    overlap it (each memory-mapped; only the overlap is read)."""
    out = np.empty([b - a for a, b in zip(start, stop)], dtype=np.dtype(index["dtype"]))
    filled = 0
    for entry in index["shards"]:
        lo = [max(a, s) for a, s in zip(start, entry["start"])]
        hi = [min(b, e) for b, e in zip(stop, entry["stop"])]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        src = np.load(os.path.join(path, entry["file"]), mmap_mode="r")
        src_sl = tuple(slice(a - s, b - s) for a, b, s in zip(lo, hi, entry["start"]))
        dst_sl = tuple(slice(a - s, b - s) for a, b, s in zip(lo, hi, start))
        out[dst_sl] = src[src_sl]
        filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
    if filled != out.size:
        raise ValueError(f"checkpoint {path} does not cover [{start}, {stop})")
    return out


def load_sharded(path: str, sharding=None, shape=None, dtype=None):
    """Restore a checkpoint.

    With ``sharding`` (a ``parallel.mesh.NamedSharding``) the result is a
    ``ShardedTensor`` on that mesh and spec, each shard read from only the
    ranges it needs; ``shape``, when given, must be the saved shape, and
    ``dtype`` casts.  Without it, the whole array comes back as a host numpy
    array.
    """
    from seekr_tpu_torch.parallel.mesh import (DATA_AXIS, KMER_AXIS, Shard, ShardedTensor,
                                               shard_index)

    path = os.path.abspath(path)
    with open(os.path.join(path, INDEX)) as fh:
        index = json.load(fh)
    saved = tuple(index["shape"])
    if shape is not None and tuple(shape) != saved:
        raise ValueError(f"checkpoint {path} holds shape {saved}, not {tuple(shape)}")
    if sharding is None:
        host = _read_range(path, index, [0] * len(saved), list(saved))
        return host if dtype is None else host.astype(dtype)
    mesh = sharding.mesh
    shards, cache = [], {}
    for i in range(mesh.shape[DATA_AXIS]):
        for j in range(mesh.shape[KMER_AXIS]):
            sl = shard_index(sharding, saved, (i, j))
            key = tuple((s.start, s.stop) for s in sl)
            if key not in cache:  # replicas are read once
                host = _read_range(path, index, [s.start for s in sl], [s.stop for s in sl])
                cache[key] = torch.from_numpy(host if dtype is None else host.astype(dtype))
            dev = mesh.devices[i, j]
            shards.append(Shard(dev, sl, cache[key].to(dev, copy=True)))
    return ShardedTensor(saved, shards[0].data.dtype, sharding, shards)


def save_pipeline_state(directory: str, *, counts=None, mean=None, std=None,
                        sim=None) -> None:
    """Persist any subset of pipeline intermediates under ``directory``.

    Sharded (or whole) matrices go to ``counts/`` and ``pearson/`` checkpoints;
    the vectors as ``mean.npy``/``std.npy`` with the reference's artifact
    semantics (loadable by BasicCounter's mean=/std=), the bytes seekr_tpu
    writes for the same values.
    """
    os.makedirs(directory, exist_ok=True)
    if counts is not None:
        save_sharded(os.path.join(directory, "counts"), counts)
    if sim is not None:
        save_sharded(os.path.join(directory, "pearson"), sim)
    if mean is not None:
        np.save(os.path.join(directory, "mean.npy"), _host(mean))
    if std is not None:
        np.save(os.path.join(directory, "std.npy"), _host(std))
