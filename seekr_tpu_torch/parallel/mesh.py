"""A device mesh, and the placement of tensors on it.

Port of ``seekr_tpu/parallel/mesh.py``.  seekr_tpu shards over a
``jax.sharding.Mesh`` with two logical axes:

  * ``data`` -- transcripts (rows of the count matrix), the main scaling axis;
  * ``kmer`` -- the 4^k histogram columns, sharded only when 4^k strains one
    device's memory (k >= 8).

Here the mesh is explicit: a ``Mesh`` is a ``(data, kmer)`` grid of
``torch.device``s, each position owned by one process; ``shard`` splits a
tensor into the pieces of this process's positions (``.to(device)``); the
per-shard work is launched on each shard's device, so launches on different
cards run concurrently; partial results are reduced in a fixed shard order
(``parallel/dist.py``), across processes by exchanging the parts
(``parallel/comm.py``).  A grid may repeat a device: ``[cpu] * 8`` is the
counterpart of seekr_tpu's 8 virtual CPU devices, and ``[cuda:0] * 4`` runs
every line of the sharded code on one card.

Across processes (``comm.init_distributed``, one process per host or per
card), ``make_mesh`` takes each process's own devices and joins them in
process order, as ``jax.devices()`` orders them; a ``ShardedTensor`` then
holds only this process's shards (``addressable_shards``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from seekr_tpu_torch.parallel import comm

DATA_AXIS = "data"
KMER_AXIS = "kmer"


class Mesh:
    """A ``(data, kmer)`` grid of devices, each position owned by a process.

    ``devices`` is the ``[n_data, n_kmer]`` object array of ``torch.device``s
    (as ``jax.sharding.Mesh.devices``; a device is named as its owner sees
    it), ``owners`` the ``[n_data, n_kmer]`` process indices (default: this
    process), ``shape`` maps each axis name to its size, and ``size`` is the
    number of grid positions (repeats included).  ``local_positions`` are this
    process's positions, row-major.
    """

    axis_names = (DATA_AXIS, KMER_AXIS)

    def __init__(self, grid, owners=None):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, dev in enumerate(row):
                self.devices[i, j] = dev
        self.process = comm.process_index()
        self.owners = (np.full(self.devices.shape, self.process, dtype=np.int64)
                       if owners is None else np.asarray(owners, dtype=np.int64))
        if self.owners.shape != self.devices.shape:
            raise ValueError("owners must have the grid's shape")
        self.shape = {DATA_AXIS: len(rows), KMER_AXIS: len(rows[0])}
        self.size = int(self.devices.size)
        self.local_positions = [(i, j) for i in range(len(rows)) for j in range(len(rows[0]))
                                if self.owners[i, j] == self.process]
        if not self.local_positions:
            raise ValueError(f"process {self.process} owns no position of the mesh")
        self.spans_processes = len(set(self.owners.flat)) > 1

    def is_local(self, i: int, j: int) -> bool:
        return bool(self.owners[i, j] == self.process)

    @property
    def first(self) -> torch.device:
        """This process's first device: where its partial results are reduced
        and replicated outputs gathered."""
        return self.devices[self.local_positions[0]]

    def row_device(self, i: int) -> Optional[torch.device]:
        """This process's first device in data row ``i`` (None if it has none)."""
        for j in range(self.shape[KMER_AXIS]):
            if self.is_local(i, j):
                return self.devices[i, j]
        return None

    def column_device(self, j: int) -> torch.device:
        """This process's first device in kmer column ``j``, else ``first``."""
        for i in range(self.shape[DATA_AXIS]):
            if self.is_local(i, j):
                return self.devices[i, j]
        return self.first


def _visible_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def global_devices(local: Optional[Sequence] = None) -> list:
    """``(process, device)`` of every device of the run, in process order: this
    process contributes ``local`` (default: its visible cards).  Once several
    processes are joined, every process must call it (an exchange over the
    control group)."""
    if local is None:
        local = _visible_cards()
        if not local:
            raise RuntimeError(
                "no CUDA card is visible, so make_mesh() has no devices; pass "
                "devices=[torch.device('cpu')] * n for a mesh of n CPU shards")
    local = [torch.device(d) for d in local]
    if comm.process_count() == 1:
        return [(0, d) for d in local]
    every = comm.gather_objects([str(d) for d in local])
    return [(proc, torch.device(d)) for proc, names in enumerate(every) for d in names]


def _grid_mesh(pairs, kmer_parallel: int) -> Mesh:
    n = len(pairs)
    if kmer_parallel < 1 or n % kmer_parallel:
        raise ValueError("device count must be divisible by kmer_parallel")
    rows = [pairs[i:i + kmer_parallel] for i in range(0, n, kmer_parallel)]
    return Mesh([[d for _, d in row] for row in rows],
                owners=[[p for p, _ in row] for row in rows])


def make_mesh(devices: Optional[Sequence] = None, kmer_parallel: int = 1) -> Mesh:
    """Build a (data, kmer) mesh over the given devices (default: every visible
    CUDA card; never the CPU unless it is listed).  Once several processes are
    joined, ``devices`` are this process's and the mesh spans every process's,
    in process order."""
    return _grid_mesh(global_devices(devices), kmer_parallel)


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
    position of this process, in row-major grid order
    (``addressable_shards``; every position in one process).  ``np.asarray``
    gathers it to the host and ``gather(device)`` assembles it on one device,
    when this process holds all of it: every shard, or one replica of a
    replicated tensor."""

    def __init__(self, shape, dtype, sharding: NamedSharding, shards):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = list(shards)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def addressable_shards(self) -> list:
        """The shards this process holds."""
        return self.shards

    @property
    def is_fully_addressable(self) -> bool:
        """Whether this process holds every shard (a mesh in one process)."""
        return not self.sharding.mesh.spans_processes

    def unique_shards(self):
        """One shard per distinct index (the first of its replicas)."""
        seen = {}
        for s in self.shards:
            seen.setdefault(tuple((sl.start, sl.stop) for sl in s.index), s)
        return list(seen.values())

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first device of
        this process).  Raises where other processes hold part of it."""
        if not self.is_fully_addressable and any(
                (sl.start, sl.stop) != (0, n) for sl, n in zip(self.shards[0].index, self.shape)):
            raise RuntimeError(
                "this tensor spans the devices of several processes, so it cannot "
                "be assembled in one; read its addressable_shards here, or gather "
                "the parts across processes (parallel.comm.all_gather_parts)")
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
    ``NamedSharding``): each of this process's grid positions gets its slice
    ``.to`` its device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    mesh = sharding.mesh
    shards = []
    for pos in mesh.local_positions:
        index = shard_index(sharding, t.shape, pos)
        dev = mesh.devices[pos]
        shards.append(Shard(dev, index, t[index].to(dev, copy=True)))
    return ShardedTensor(t.shape, t.dtype, sharding, shards)


def build_mesh_from_flags(data_parallel, kmer_parallel=1, coordinator=None,
                          num_processes=None, process_id=None, device=None):
    """CLI-flag mesh construction shared by the -dp/-kp flags.

    Returns None when no parallelism was requested (the single-device path);
    ``-kp`` without ``-dp`` still builds a mesh.  Joins the processes first
    when ``num_processes`` > 1 (``comm.init_distributed``; a ``coordinator``
    alone changes nothing, as in seekr_tpu).  ``device`` picks the kind of
    device: ``"cpu"`` gives CPU shards (split evenly over the processes),
    anything else (``None``, a CUDA device) the visible CUDA cards of every
    process, of which there must be enough.  A mesh across processes uses
    every device of the run.
    """
    if num_processes and num_processes > 1:
        comm.init_distributed(coordinator=coordinator, num_processes=num_processes,
                              process_id=process_id, device=device)
    kmer_parallel = max(kmer_parallel or 1, 1)
    if not data_parallel and kmer_parallel > 1:
        data_parallel = 1  # -kp without -dp still builds a mesh
    if not data_parallel or data_parallel * kmer_parallel <= 1:
        return None

    need = data_parallel * kmer_parallel
    procs = comm.process_count()
    if device is not None and torch.device(device).type == "cpu":
        if need % procs:
            raise ValueError(f"{need} CPU shards do not divide over {procs} processes")
        devices = global_devices([torch.device("cpu")] * (need // procs))
    else:
        devices = global_devices(_visible_cards())
    if need > len(devices):
        raise ValueError(f"requested {need} devices "
                         f"(data_parallel={data_parallel} x "
                         f"kmer_parallel={kmer_parallel}), "
                         f"have {len(devices)}")
    if procs > 1 and need != len(devices):
        raise ValueError(
            f"multi-host runs must use all {len(devices)} devices: set "
            f"data_parallel x kmer_parallel == {len(devices)}")
    return _grid_mesh(devices[:need], kmer_parallel)
