"""A device mesh in one process, and the placement of tensors on it.

Port of ``seekr_tpu/parallel/mesh.py``.  seekr_tpu shards over a
``jax.sharding.Mesh`` with two logical axes:

  * ``data`` -- transcripts (rows of the count matrix), the main scaling axis;
  * ``kmer`` -- the 4^k histogram columns, sharded only when 4^k strains one
    device's memory (k >= 8).

On one host that mesh is single-controller: one process places the shards and
reduces across them.  Here the same is explicit: a ``Mesh`` is a
``(data, kmer)`` grid of ``torch.device``s; ``shard`` splits a tensor into its
per-device pieces (``.to(device)``); the per-shard work is launched on each
shard's device, so launches on different cards run concurrently; partial
results are reduced on the first device, in a fixed shard order
(``parallel/dist.py``).  A grid may repeat a device: ``[cpu] * 8`` is the
counterpart of seekr_tpu's 8 virtual CPU devices, and ``[cuda:0] * 4`` runs
every line of the sharded code on one card.  Meshes across processes and hosts
(``torch.distributed``) come with the port's slice 9.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
KMER_AXIS = "kmer"
MULTI_HOST = ("multi-host runs (one process per host, torch.distributed) come with "
              "the port's slice 9")


class Mesh:
    """A ``(data, kmer)`` grid of devices.

    ``devices`` is the ``[n_data, n_kmer]`` object array of ``torch.device``s
    (as ``jax.sharding.Mesh.devices``), ``shape`` maps each axis name to its
    size, and ``size`` is the number of grid positions (repeats included).
    """

    axis_names = (DATA_AXIS, KMER_AXIS)

    def __init__(self, grid):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, dev in enumerate(row):
                self.devices[i, j] = dev
        self.shape = {DATA_AXIS: len(rows), KMER_AXIS: len(rows[0])}
        self.size = int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """Where partial results are reduced and replicated outputs gathered."""
        return self.devices[0, 0]


def make_mesh(devices: Optional[Sequence] = None, kmer_parallel: int = 1) -> Mesh:
    """Build a (data, kmer) mesh over the given devices (default: every visible
    CUDA card; never the CPU unless it is listed)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA card is visible, so make_mesh() has no devices; pass "
                "devices=[torch.device('cpu')] * n for a mesh of n CPU shards")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if kmer_parallel < 1 or n % kmer_parallel:
        raise ValueError("device count must be divisible by kmer_parallel")
    per = n // kmer_parallel
    return Mesh([devices[i * kmer_parallel:(i + 1) * kmer_parallel] for i in range(per)])


def pad_to_shards(n: int, n_shards: int) -> int:
    """Round row count up so it divides evenly across data shards."""
    return -(-n // n_shards) * n_shards


# -- placement ---------------------------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """Where a tensor's pieces live: ``spec`` has one entry per dimension, None
    (replicated), an axis name, or a tuple of axis names (their grid positions
    flattened row-major), as ``jax.sharding.PartitionSpec``; trailing
    dimensions left out are replicated."""

    mesh: Mesh
    spec: tuple = ()


def data_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Rows sharded over 'data', remaining axes replicated."""
    return NamedSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def row_col_sharding(mesh: Mesh) -> NamedSharding:
    """[rows, cols] sharded over ('data', 'kmer')."""
    return NamedSharding(mesh, (DATA_AXIS, KMER_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(sharding: NamedSharding, shape, pos) -> tuple:
    """The slices of a global ``shape`` held at grid position ``pos`` (i, j)."""
    mesh = sharding.mesh
    coord = dict(zip(mesh.axis_names, pos))
    index = []
    for dim, size in enumerate(shape):
        axes = _axes(sharding.spec[dim]) if dim < len(sharding.spec) else ()
        parts, part = 1, 0
        for name in axes:  # row-major over the axis tuple
            parts *= mesh.shape[name]
            part = part * mesh.shape[name] + coord[name]
        if size % parts:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not divide over "
                             f"the {parts} shards of {axes}")
        step = size // parts
        index.append(slice(part * step, (part + 1) * step))
    return tuple(index)


@dataclass
class Shard:
    device: torch.device
    index: tuple          # slices of the global tensor
    data: torch.Tensor


class ShardedTensor:
    """A global tensor held as per-device pieces: one ``Shard`` per grid
    position, in row-major grid order.  ``np.asarray`` gathers it to the host;
    ``gather(device)`` assembles it on one device."""

    def __init__(self, shape, dtype, sharding: NamedSharding, shards):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = list(shards)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def unique_shards(self):
        """One shard per distinct index (the first of its replicas)."""
        seen = {}
        for s in self.shards:
            seen.setdefault(tuple((sl.start, sl.stop) for sl in s.index), s)
        return list(seen.values())

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first device)."""
        dev = self.sharding.mesh.first if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for s in self.unique_shards():
            out[s.index] = s.data.to(dev)
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.gather("cpu").numpy()
        return out if dtype is None else out.astype(dtype)


def shard(x, sharding: NamedSharding) -> ShardedTensor:
    """Place a host array or tensor on the mesh (``jax.device_put`` with a
    ``NamedSharding``): each grid position gets its slice ``.to`` its device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    mesh = sharding.mesh
    shards = []
    for i in range(mesh.shape[DATA_AXIS]):
        for j in range(mesh.shape[KMER_AXIS]):
            index = shard_index(sharding, t.shape, (i, j))
            dev = mesh.devices[i, j]
            shards.append(Shard(dev, index, t[index].to(dev, copy=True)))
    return ShardedTensor(t.shape, t.dtype, sharding, shards)


def build_mesh_from_flags(data_parallel, kmer_parallel=1, coordinator=None,
                          num_processes=None, process_id=None, device=None):
    """CLI-flag mesh construction shared by the -dp/-kp flags.

    Returns None when no parallelism was requested (the single-device path);
    ``-kp`` without ``-dp`` still builds a mesh.  ``device`` picks the kind of
    device: ``"cpu"`` gives a mesh of CPU shards, anything else (``None``, a
    CUDA device) the visible CUDA cards, of which there must be enough.  A
    multi-host bootstrap (``num_processes`` > 1 or a ``coordinator``) raises.
    """
    from seekr_tpu_torch.parallel.dist import init_distributed

    init_distributed(coordinator=coordinator, num_processes=num_processes,
                     process_id=process_id)
    if coordinator is not None:
        raise NotImplementedError(f"--coordinator {coordinator}: {MULTI_HOST}")
    kmer_parallel = max(kmer_parallel or 1, 1)
    if not data_parallel and kmer_parallel > 1:
        data_parallel = 1  # -kp without -dp still builds a mesh
    if not data_parallel or data_parallel * kmer_parallel <= 1:
        return None

    need = data_parallel * kmer_parallel
    if device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")] * need
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    if need > len(devices):
        raise ValueError(f"requested {need} devices "
                         f"(data_parallel={data_parallel} x "
                         f"kmer_parallel={kmer_parallel}), "
                         f"have {len(devices)}")
    return make_mesh(devices[:need], kmer_parallel=kmer_parallel)
