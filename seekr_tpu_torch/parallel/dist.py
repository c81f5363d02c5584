"""The seekr pipeline over a device mesh, in one process or across several.

Port of ``seekr_tpu/parallel/dist.py``.  Three kinds of parallelism (the
reference has none):

  * data parallel -- transcripts sharded over the 'data' axis; the column
    mean/std are reductions of per-shard partial sums;
  * kmer parallel -- the 4^k histogram columns sharded over 'kmer'; the Pearson
    Gram is the sum over kmer shards of partial products;
  * sequence parallel -- one very long transcript split into position chunks
    with a (k-1)-base halo; the integer partial histograms are summed.

seekr_tpu lets GSPMD insert the collectives from sharding annotations.  Here
each step is written out: the per-shard work is launched on each shard's
device (``count_graph``: the CUDA kernels on a card), and each reduction adds
the per-shard partial results in a fixed global shard order.  A process works
on its own grid positions only; where a reduction needs another process's
partials, they are exchanged first (``_exchange``: ``comm.all_gather_parts``)
and then added in the same order, so a mesh over P processes gives the bits of
one process holding the same grid.  ``_mesh_compatible`` (seekr_tpu
``dist.py:237-256``) works around a JAX placement rule and has no counterpart:
a tensor here moves with ``.to(device)``.

Serving over a mesh: ``ShardedScorer`` (the two-stage top-k) and, for a mesh
across processes, ``PodScorer`` (the leader's broadcast of each call, mirrored
by the followers); ``make_sharded_scorer`` picks one.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from seekr_tpu_torch.ops.count import count_graph, split_long_digits
from seekr_tpu_torch.ops.math import accurate_log2
from seekr_tpu_torch.ops.normalize import LOG2_POST, LOG2_PRE, check_log2_mode
from seekr_tpu_torch.ops.pearson import _row_standardize, as_float32, divide, gram, matmul_nt
from seekr_tpu_torch.parallel import comm
from seekr_tpu_torch.parallel.comm import (init_distributed, process_count,  # noqa: F401
                                           process_index)
from seekr_tpu_torch.parallel.mesh import (DATA_AXIS, KMER_AXIS, Mesh, NamedSharding, Shard,
                                           ShardedTensor, pad_to_shards, replicated, shard,
                                           shard_index)

def _exchange(mesh: Mesh, parts: dict, device=None) -> dict:
    """Every process's ``{key: tensor}`` parts, merged (received ones on
    ``device``, default this process's first); in one process, ``parts``."""
    if not mesh.spans_processes:
        return parts
    return comm.all_gather_parts(parts, mesh.first if device is None else device)


def _exchange_rows(mesh: Mesh, parts: dict) -> dict:
    """``_exchange`` of per-position parts that only the processes of the same
    data row need: skipped where no data row spans two processes."""
    if any(len(set(row)) > 1 for row in mesh.owners):
        return comm.all_gather_parts(parts, mesh.first)
    return parts


def _local_rows(mesh: Mesh):
    """The data rows where this process holds a position."""
    return [i for i in range(mesh.shape[DATA_AXIS]) if mesh.row_device(i) is not None]


def _on(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()


def _check_rows(mesh: Mesh, m: int) -> int:
    n_data = mesh.shape[DATA_AXIS]
    if m % n_data:
        raise ValueError(f"{m} rows do not divide over the {n_data}-device data axis; "
                         f"pad them to {pad_to_shards(m, n_data)} (pad_to_shards)")
    return m // n_data


def _sharded_count(mesh: Mesh, bases, lengths, k: int, flat: bool = True):
    """Row-sharded k-mer counting: one count per data shard.

    Data shard i (rows ``i * M/n_data`` onwards) is counted by ``count_graph``
    on this process's first device of data row i (``mesh.devices[i, 0]`` in
    one process): the CUDA kernel on a card, the plain version on the CPU.
    seekr_tpu counts it again on every kmer replica (``dist.py:60-66``) for the
    same numbers; the pipeline sends each column slice to its kmer device
    instead.  Returns the per-shard count tensors, None for a shard of which
    this process holds no position.
    """
    m_loc = _check_rows(mesh, int(bases.shape[0]))
    out = []
    for i in range(mesh.shape[DATA_AXIS]):
        dev = mesh.row_device(i)
        if dev is None:
            out.append(None)
            continue
        rows = slice(i * m_loc, (i + 1) * m_loc)
        out.append(count_graph(_on(bases[rows], dev, torch.int8),
                               _on(lengths[rows], dev, torch.int32), k, flat=flat))
    return out


def _column_split(mesh: Mesh, per_row) -> dict:
    """``{(i, j): data shard i's column slice j on mesh.devices[i, j]}`` for this
    process's positions (for an unflattened count tensor, a slice of n_hi)."""
    n_kmer = mesh.shape[KMER_AXIS]
    grid = {}
    for i, j in mesh.local_positions:
        x = per_row[i]
        step = x.shape[1] // n_kmer
        grid[(i, j)] = x[:, j * step:(j + 1) * step].to(mesh.devices[i, j])
    return grid


def _column_totals(mesh: Mesh, grid: dict, m_total: int, n_slices: Optional[int] = None):
    """Per column slice j: the sum over data shards, in shard order, of each
    shard's column sums, on ``mesh.column_device(j)`` (``mesh.devices[0, j]``
    in one process), divided by ``m_total``.  ``grid`` holds this process's
    shards; every column slice comes back, on every process."""
    every = _exchange(mesh, {pos: x.sum(dim=0) for pos, x in grid.items()})
    totals = []
    for j in range(mesh.shape[KMER_AXIS] if n_slices is None else n_slices):
        dev = mesh.column_device(j)
        acc = None
        for i in range(mesh.shape[DATA_AXIS]):
            part = every[(i, j)].to(dev)
            acc = part if acc is None else acc + part
        totals.append(divide(acc, m_total))
    return totals


def _broadcast(grid: dict, vecs) -> dict:
    """``vecs[j]`` on the device of each shard ``(i, j)`` of ``grid``."""
    return {pos: vecs[pos[1]].to(x.device) for pos, x in grid.items()}


def _column_mean_std(mesh: Mesh, grid: dict, m_total: int, n_slices: Optional[int] = None):
    """Column mean and the two-pass POPULATION std of ``grid``, as ``jnp.mean``
    and ``jnp.std``: the mean first, then the mean of squared deviations from
    it (never E[x^2] - E[x]^2)."""
    mean = _column_totals(mesh, grid, m_total, n_slices)
    mean_b = _broadcast(grid, mean)
    sq = {pos: (x - mean_b[pos]) ** 2 for pos, x in grid.items()}
    std = [torch.sqrt(v) for v in _column_totals(mesh, sq, m_total, n_slices)]
    return mean, std


def _global_min(mesh: Mesh, grid: dict) -> torch.Tensor:
    """min over every shard, in row-major shard order, on this process's first
    device; ``torch.minimum`` carries a NaN as ``jnp.min`` does (Python's
    ``min`` would not)."""
    every = _exchange(mesh, {pos: x.amin() for pos, x in grid.items()})
    acc = None
    for pos in sorted(every):
        part = every[pos].to(mesh.first)
        acc = part if acc is None else torch.minimum(acc, part)
    return acc


def _row_standardize_sharded(mesh: Mesh, grid: dict, n_cols: int) -> dict:
    """``ops.pearson._row_standardize`` of rows whose columns are split over
    the kmer axis: each row's sums run over its kmer shards in order, reduced
    on ``mesh.row_device(i)`` (``mesh.devices[i, 0]`` in one process)."""
    rows = _local_rows(mesh)

    def row_means(parts):
        every = _exchange_rows(mesh, {pos: x.reshape(x.shape[0], -1).sum(dim=1)
                                      for pos, x in parts.items()})
        means = {}
        for i in rows:
            home = mesh.row_device(i)
            acc = None
            for j in range(mesh.shape[KMER_AXIS]):
                s = every[(i, j)].to(home)
                acc = s if acc is None else acc + s
            means[i] = divide(acc, n_cols)
        return means

    def per_shard(v, x):
        return v.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))

    mu = row_means(grid)
    c = {pos: x - per_shard(mu[pos[0]], x) for pos, x in grid.items()}
    mu2 = row_means(c)  # the std is taken around the centered rows' own mean
    sd = {i: torch.sqrt(v) for i, v in row_means(
        {pos: (x - per_shard(mu2[pos[0]], x)) ** 2 for pos, x in c.items()}).items()}
    return {pos: x / per_shard(sd[pos[0]], x) for pos, x in c.items()}


def _sharded_gram(mesh: Mesh, z: dict, n_cols: int) -> dict:
    """Per data row i of this process: ``z_i @ Z^T / n_cols`` with Z the
    standardized rows of every shard; the Gram is the sum over kmer shards j
    of partial ``[M_loc, M]`` products (``ops.pearson.gram``) against column
    slice j of every row (exchanged across processes: the right operand),
    added on ``mesh.row_device(i)`` in shard order."""
    n_data, n_kmer = mesh.shape[DATA_AXIS], mesh.shape[KMER_AXIS]
    flat = {pos: x.reshape(x.shape[0], -1) for pos, x in z.items()}
    every = _exchange(mesh, flat)
    right = {}  # (j, device) -> column slice j of every row, on that device
    partial = {}
    for i, j in mesh.local_positions:
        dev = mesh.devices[i, j]
        key = (j, str(dev))
        if key not in right:
            right[key] = torch.cat([every[(r, j)].to(dev) for r in range(n_data)])
        partial[(i, j)] = gram(flat[(i, j)], right[key])
    del every, right
    partial = _exchange_rows(mesh, partial)
    sims = {}
    for i in _local_rows(mesh):
        home = mesh.row_device(i)
        acc = None
        for j in range(n_kmer):
            part = partial.pop((i, j)).to(home)
            acc = part if acc is None else acc + part
        sims[i] = divide(acc, n_cols)
    return sims


def _grid_tensor(mesh: Mesh, shape, spec, grid: dict) -> ShardedTensor:
    sharding = NamedSharding(mesh, spec)
    shards = [Shard(mesh.devices[pos], shard_index(sharding, shape, pos), grid[pos])
              for pos in mesh.local_positions]
    return ShardedTensor(shape, shards[0].data.dtype, sharding, shards)


def _vector_slices(mesh: Mesh, v, trailing):
    """A provided flat [4^k] norm vector cut into the mesh's column slices, each
    on ``mesh.column_device(j)`` in the count tensor's trailing shape (float64
    .npy vectors are cast, as seekr_tpu does, so they do not promote the
    chain)."""
    n_kmer = mesh.shape[KMER_AXIS]
    v = torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v))
    parts = v.reshape(-1).reshape(n_kmer, -1)
    return [parts[j].to(device=mesh.column_device(j), dtype=torch.float32).reshape(trailing)
            for j in range(n_kmer)]


def _kmer_vector(mesh: Mesh, vecs) -> ShardedTensor:
    """Per-kmer-slice vectors as one flat [4^k] vector sharded over 'kmer'."""
    flat = [v.reshape(-1) for v in vecs]
    shape = (sum(v.shape[0] for v in flat),)
    return _grid_tensor(mesh, shape, (KMER_AXIS,),
                        {pos: flat[pos[1]].to(mesh.devices[pos]) for pos in mesh.local_positions})


def _pipeline_fn(mesh: Mesh, bases, lengths, mean, std, k: int, log2: str, flat: bool):
    """Encoded bases -> (normalized counts, mean, std, Pearson) on the mesh.

    The epilogue is ``models/pipeline``'s normalize chain with its three
    global reductions written out: the column mean and std over 'data', the
    Log2.post ``min`` over every shard, and the Pearson row standardization
    over 'kmer'.
    """
    n_kmer = mesh.shape[KMER_AXIS]
    raw = _sharded_count(mesh, bases, lengths, k, flat=flat)
    held = next(x for x in raw if x is not None)
    if not flat and held.shape[1] % n_kmer:
        raise ValueError(
            f"flat=False shards the 3-D count tensor's n_hi axis "
            f"(= {held.shape[1]} for k={k} under the current count "
            f"implementation) over the {n_kmer}-device kmer axis, "
            f"which requires divisibility; use flat=True (4^k columns "
            f"shard much finer) or a smaller kmer_parallel.")
    m_total, n_cols = int(bases.shape[0]), 4 ** k
    x = _column_split(mesh, raw)
    del raw, held
    if log2 == LOG2_PRE:
        x = {pos: accurate_log2(c + 1.0) for pos, c in x.items()}
    trailing = next(iter(x.values())).shape[1:]
    if mean is None:
        mean_v = _column_totals(mesh, x, m_total)
    else:
        mean_v = _vector_slices(mesh, mean, trailing)
    mean_b = _broadcast(x, mean_v)
    x = {pos: c - mean_b[pos] for pos, c in x.items()}
    std_v = (_column_mean_std(mesh, x, m_total)[1] if std is None
             else _vector_slices(mesh, std, trailing))
    std_b = _broadcast(x, std_v)
    x = {pos: c / std_b[pos] for pos, c in x.items()}
    if log2 == LOG2_POST:
        shift = _global_min(mesh, x).abs()
        x = {pos: accurate_log2(c + shift.to(c.device) + 1.0) for pos, c in x.items()}

    sims = _sharded_gram(mesh, _row_standardize_sharded(mesh, x, n_cols), n_cols)
    shape = (m_total,) + tuple(int(s) * (n_kmer if d == 0 else 1)
                               for d, s in enumerate(trailing))
    spec = (DATA_AXIS, KMER_AXIS) + (None,) * (len(trailing) - 1)
    normalized = _grid_tensor(mesh, shape, spec, x)
    sim = _grid_tensor(mesh, (m_total, m_total), (DATA_AXIS, None),
                       {pos: sims[pos[0]].to(mesh.devices[pos]) for pos in mesh.local_positions})
    if mean is None:
        mean_out = shard(torch.cat([v.reshape(-1).to(mesh.first) for v in mean_v]),
                         replicated(mesh))
        std_out = shard(torch.cat([v.reshape(-1).to(mesh.first) for v in std_v]),
                        replicated(mesh))
    else:
        mean_out, std_out = _kmer_vector(mesh, mean_v), _kmer_vector(mesh, std_v)
    return normalized, mean_out, std_out, sim


def distributed_pipeline(mesh: Mesh, k: int = 6, log2: str = "Log2.post",
                         use_norm_vectors: bool = False, flat: bool = True):
    """The full pipeline step over a mesh.

    Returns a function (bases [M, L] int8, lengths [M] int32) -> (normalized
    counts [M, 4^k], mean, std, pearson [M, M]), each a ``ShardedTensor``
    (``np.asarray`` gathers it): counts with rows sharded over 'data' and
    histogram columns over 'kmer', pearson with rows over 'data'.  M must divide
    by the data-axis size.  Across processes every process passes the same
    whole inputs, takes part, and holds its own shards of each output (mean
    and std whole, replicated).

    With ``use_norm_vectors`` the function takes two extra [4^k] vectors (the
    BasicCounter mean=/std=-from-.npy mode) instead of computing the column
    statistics, and returns them sharded over 'kmer'; otherwise the computed
    vectors come back replicated.  ``flat=False`` returns the normalized counts
    as [M, n_hi, n_lo] with n_hi sharded over 'kmer' (the row-major bytes are
    the flat matrix); mean/std stay flat.
    """
    check_log2_mode(log2)
    kmer_size = mesh.shape[KMER_AXIS]
    if (flat or use_norm_vectors) and (4 ** k) % kmer_size:
        what = ("the flat count matrix and norm vectors shard"
                if flat else "the [4^k] norm vectors shard")
        raise ValueError(
            f"{what} {4 ** k} histogram columns (k={k}) over the "
            f"{kmer_size}-device kmer axis, which requires divisibility; "
            f"choose a power-of-two kmer_parallel (columns are 4^k).")
    if use_norm_vectors:
        def step(bases, lengths, mean, std):
            return _pipeline_fn(mesh, bases, lengths, mean, std, k, log2, flat)
    else:
        def step(bases, lengths):
            return _pipeline_fn(mesh, bases, lengths, None, None, k, log2, flat)
    return step


def distributed_norm_stats(mesh: Mesh, k: int = 6, log2: str = "Log2.post"):
    """A sharded norm-vector computation (the seekr_norm_vectors analog).

    Returns a function (bases, lengths) -> (mean, std), each a replicated
    ``ShardedTensor``: the column mean and two-pass population std of the count
    matrix (after ``log2(x + 1)`` under Log2.pre), rows sharded over 'data'.
    Data shard i's sums come from the process of position (i, 0).
    """
    check_log2_mode(log2)

    def step(bases, lengths):
        raw = _sharded_count(mesh, bases, lengths, k)
        # full columns of each data shard, held at (i, 0)
        grid = {(i, 0): x for i, x in enumerate(raw) if mesh.is_local(i, 0)}
        if log2 == LOG2_PRE:
            grid = {pos: accurate_log2(x + 1.0) for pos, x in grid.items()}
        mean, std = _column_mean_std(mesh, grid, int(bases.shape[0]), n_slices=1)
        return (shard(mean[0].to(mesh.first), replicated(mesh)),
                shard(std[0].to(mesh.first), replicated(mesh)))

    return step


def count_long_sequence(mesh: Mesh, k: int):
    """Sequence-parallel counting of ONE long transcript.

    Returns a function (chunks [n_dev, chunk + k - 1] int8, n_windows) -> [4^k]
    float32 counts per kb on this process's first device (every process gets
    the whole row).  Position d of the mesh (row-major) counts chunk d with its
    halo, unscaled, through ``count_graph``; the integer partials are summed
    in position order (exact in any order), then scaled as seekr_tpu does
    here: by the float32 quotient ``1000 / float32(n_windows)``, zeros when
    ``n_windows <= 0``.
    """
    positions = [(i, j) for i in range(mesh.shape[DATA_AXIS])
                 for j in range(mesh.shape[KMER_AXIS])]

    def step(chunks, n_windows):
        if int(chunks.shape[0]) != len(positions):
            raise ValueError(f"{chunks.shape[0]} chunks for a {len(positions)}-device mesh "
                             "(shard_long_sequence(digits, k, mesh.size))")
        parts = {}
        for d, pos in enumerate(positions):
            if not mesh.is_local(*pos):
                continue
            dev = mesh.devices[pos]
            chunk = _on(chunks[d:d + 1], dev, torch.int8)
            width = torch.tensor([chunk.shape[1]], dtype=torch.int32, device=dev)
            parts[d] = count_graph(chunk, width, k, scaled=False)[0]
        every = _exchange(mesh, parts)
        total = None
        for d in range(len(positions)):
            part = every[d].to(mesh.first)
            total = part if total is None else total + part
        nw = torch.tensor(float(np.float32(n_windows)), dtype=torch.float32,
                          device=mesh.first)
        num = torch.tensor(1000.0, dtype=torch.float32, device=mesh.first)
        # a transcript shorter than k has no windows: zeros, not 0 * inf = NaN
        scale = torch.where(nw > 0, num / nw, torch.zeros_like(nw))
        return total * scale

    return step


def _standardized_shards(counts, devices: dict, m_pad: int, n_data: int) -> dict:
    """Row shards d of the row-standardized ``counts`` on ``devices[d]``, for
    the shards of ``devices``; zero rows padded in AFTER standardizing (the pad
    never reaches a writer)."""
    m = int(counts.shape[0])
    m_loc = m_pad // n_data
    out = {}
    for d, dev in devices.items():
        lo, hi = min(d * m_loc, m), min((d + 1) * m_loc, m)
        part = torch.zeros((m_loc, int(counts.shape[1])), dtype=torch.float32, device=dev)
        if hi > lo:
            part[:hi - lo] = _row_standardize(as_float32(counts[lo:hi], dev))
        out[d] = part
    return out


def _block_pieces(shards: dict, m_loc: int, start: int, rows: int) -> dict:
    """Rows [start, start + rows) of equal row shards, as ``{d: piece}`` of the
    shards held in ``shards``."""
    pieces = {}
    for d in range(start // m_loc, (start + rows - 1) // m_loc + 1):
        if d in shards:
            lo = max(start, d * m_loc) - d * m_loc
            hi = min(start + rows, (d + 1) * m_loc) - d * m_loc
            pieces[d] = shards[d][lo:hi]
    return pieces


def stream_pearson_sharded(mesh: Mesh, counts, writer, block_rows: int = 4096,
                           counts2=None):
    """All-pairs Pearson of data-sharded count matrices, streamed to the host.

    For m large enough that the [m1, m2] r-matrix fits no single device: both
    matrices are row-standardized and held as row shards over 'data' (shard i
    on ``mesh.devices[i, 0]``, by its process), zero rows padded in after
    standardizing so row counts need not divide the axis.  Each left block of
    ``block_rows`` rows is copied to every data device (across processes, its
    pieces are exchanged), each device computes its column slice of the
    [block, m2] tile (``ops.pearson.matmul_nt``), and the slices are put
    together on the host in shard order and appended to ``writer``, at most one
    tile at a time.  Across processes every process passes the same whole
    inputs, and every process's writer receives every tile.  ``counts2=None``
    streams the self-similarity; otherwise rows come from ``counts`` and
    columns from ``counts2``.  The last block is taken whole and clamped to the
    padded edge, as seekr_tpu's ``dynamic_slice`` does, so every tile has one
    shape.
    """
    n_data = mesh.shape[DATA_AXIS]
    devices = {i: mesh.devices[i, 0] for i in range(n_data) if mesh.is_local(i, 0)}
    m1 = int(counts.shape[0])
    m2 = m1 if counts2 is None else int(counts2.shape[0])
    m1_pad = pad_to_shards(m1, n_data)
    left = _standardized_shards(counts, devices, m1_pad, n_data)
    right = left if counts2 is None else _standardized_shards(
        counts2, devices, pad_to_shards(m2, n_data), n_data)
    block = min(block_rows, m1_pad)
    for start in range(0, m1, block):
        end = min(start + block, m1)
        clamped = min(start, m1_pad - block)
        off = start - clamped
        pieces = _exchange(mesh, _block_pieces(left, m1_pad // n_data, clamped, block))
        blocks = {}  # one copy of the left block per distinct device
        tiles = {}
        for d, dev in devices.items():
            if str(dev) not in blocks:
                parts = [pieces[p].to(dev) for p in sorted(pieces)]
                blocks[str(dev)] = parts[0] if len(parts) == 1 else torch.cat(parts)
            tiles[d] = matmul_nt(blocks[str(dev)], right[d])
        tiles = _exchange(mesh, tiles, device=torch.device("cpu"))
        tile = np.concatenate([tiles[d].cpu().numpy() for d in range(n_data)], axis=1)
        writer.append(tile[off:off + (end - start), :m2])


def shard_long_sequence(digits: np.ndarray, k: int, n_dev: int) -> Tuple[np.ndarray, int]:
    """Host-side prep for count_long_sequence: chunks with a (k-1)-base halo,
    padded with INVALID bases (``ops.count.split_long_digits``, shared with the
    single-device long path).  Returns (chunks [n_dev, chunk + k - 1] int8,
    n_windows)."""
    return split_long_digits(digits, k, n_dev)


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


class ShardedScorer:
    """Serving over a mesh: targets row-sharded over EVERY mesh device.

    ``targets_std`` is the [T, n_cols] ROW-STANDARDIZED target matrix
    (``ops.pearson.standardize_rows``).  It is zero-padded to a multiple of
    ``lcm(row_quantum, n_dev)`` rows and placed one row shard per device
    (row-major over the grid; across processes, each process places the shards
    of its own positions), so a corpus too big for one card lives as ~T/D rows
    per device.  Three entry points, each one shard-local GEMM per device:

      * ``sim(qc) -> [Q, t_pad]`` similarity as a ``ShardedTensor``
        column-sharded over the mesh; columns >= ``t_real`` are pad
        (``sim_host`` gathers and slices).  Across processes, the slabs are
        gathered to process 0, which holds the whole product; the others
        keep their own slabs.
        Queries are row-standardized once, on this process's first device.
      * ``topk(qc, n) -> ([Q, n'] values, [Q, n'] GLOBAL indices)``, n' =
        min(n, T), on this process's first device: a two-stage top-k.  Each
        shard masks its pad rows to -inf by global row id and keeps
        [Q, min(n', t_loc)] candidates by a stable descending sort; the
        candidates (exchanged across processes) are merged in device order,
        stably by value.  Equal values therefore go to the lower global
        index, as ``lax.top_k`` over device-ordered candidates does.
      * ``sim_and_topk(qc, n) -> (sim, vals, idx)`` from one GEMM per shard.

    A grow within the quantum keeps every shard's shape, so cuBLAS keeps its
    kernel and every existing score stays the same bit for bit.
    """

    def __init__(self, mesh: Mesh, targets_std, row_quantum: int = 1):
        self.mesh = mesh
        self.devices = list(mesh.devices.flat)
        self.n_dev = int(mesh.size)
        n_kmer = mesh.shape[KMER_AXIS]
        self._positions = [(d // n_kmer, d % n_kmer) for d in range(self.n_dev)]
        self._held = [d for d, pos in enumerate(self._positions) if mesh.is_local(*pos)]
        self.row_quantum = max(1, int(row_quantum))
        self._sharding = NamedSharding(mesh, (None, (DATA_AXIS, KMER_AXIS)))
        # the unpadded host shadow, for re-shards on grow (host RAM, not device)
        self._host = _host_f32(targets_std)
        self._shards = None
        self._load(self._host)

    def prospective_rows(self, new_total: int) -> int:
        """Padded row count a corpus of ``new_total`` real rows would occupy
        after a grow: the service's memory-budget gate asks before uploading."""
        q = int(np.lcm(self.n_dev, self.row_quantum))
        return -(-new_total // q) * q

    def _load(self, host: np.ndarray) -> None:
        """(Re)place this process's corpus shards from the host copy."""
        self.t_real, self.n_cols = (int(d) for d in host.shape)
        self.t_loc = self.prospective_rows(self.t_real) // self.n_dev
        shards = {}
        for d in self._held:
            dev = self.devices[d]
            part = host[d * self.t_loc:(d + 1) * self.t_loc]
            t = torch.zeros((self.t_loc, self.n_cols), dtype=torch.float32, device=dev)
            if len(part):
                t[:len(part)] = torch.from_numpy(np.ascontiguousarray(part)).to(dev)
            shards[d] = t
        self._shards = shards

    def grow(self, new_std) -> int:
        """Append standardized rows and re-shard; returns the new t_real.

        The old shards are dropped BEFORE the grown corpus uploads (else the
        peak is twice a corpus sized to fit once); if the upload fails, the old
        corpus is placed again so the scorer keeps answering.
        """
        old = self._host
        grown = np.concatenate([old, _host_f32(new_std)], axis=0)
        self._shards = None
        try:
            self._load(grown)
            self._host = grown
        except BaseException:
            self._load(old)
            raise
        return self.t_real

    def reload(self, host) -> None:
        """Re-shard from an explicit host corpus (a pod's unwound grow)."""
        host = _host_f32(host)
        self._shards = None
        self._load(host)
        self._host = host

    @property
    def host_corpus(self) -> np.ndarray:
        """The unpadded [t_real, n_cols] standardized corpus on the host: the
        grow shadow, which a service snapshot reads instead of the devices."""
        return self._host

    def _local(self, qc, n_local: Optional[int]) -> dict:
        """Per device held here: the [Q, t_loc] shard-local GEMM, and with
        ``n_local`` its (values, global ids) of the best ``n_local`` real rows."""
        q = _row_standardize(as_float32(qc, self.mesh.first))
        queries = {}
        out = {}
        for d in self._held:
            dev, t = self.devices[d], self._shards[d]
            if str(dev) not in queries:
                queries[str(dev)] = q.to(dev)
            sim = matmul_nt(queries[str(dev)], t)
            if n_local is None:
                out[d] = (sim, None, None)
                continue
            gid = d * self.t_loc + torch.arange(self.t_loc, dtype=torch.int32, device=dev)
            masked = sim.masked_fill((gid >= self.t_real)[None, :], float("-inf"))
            vals, pos = torch.sort(masked, dim=1, descending=True, stable=True)
            out[d] = (sim, vals[:, :n_local], gid[pos[:, :n_local]])
        return out

    def _sim_tensor(self, local: dict) -> ShardedTensor:
        q = next(iter(local.values()))[0].shape[0]
        shape = (q, self.t_loc * self.n_dev)
        if self.mesh.spans_processes:
            first = self.mesh.first
            every = comm.gather_parts({d: sim for d, (sim, _, _) in local.items()}, first)
            if comm.process_index() == 0:
                full = torch.cat([every[d].to(first) for d in range(self.n_dev)], dim=1)
                return ShardedTensor(shape, torch.float32, replicated(self.mesh),
                                     [Shard(first, (slice(0, shape[0]), slice(0, shape[1])),
                                            full)])
        shards = [Shard(self.devices[d], shard_index(self._sharding, shape, self._positions[d]),
                        sim)
                  for d, (sim, _, _) in local.items()]
        return ShardedTensor(shape, torch.float32, self._sharding, shards)

    def _merge(self, local: dict, n_out: int):
        first = self.mesh.first
        cand = {}
        for d, (_, v, i) in local.items():
            cand[("v", d)], cand[("i", d)] = v, i
        every = _exchange(self.mesh, cand)
        cand_v = torch.cat([every[("v", d)].to(first) for d in range(self.n_dev)], dim=1)
        cand_i = torch.cat([every[("i", d)].to(first) for d in range(self.n_dev)], dim=1)
        vals, pos = torch.sort(cand_v, dim=1, descending=True, stable=True)
        return vals[:, :n_out], torch.gather(cand_i, 1, pos[:, :n_out])

    def _sizes(self, n: int):
        n_out = max(1, min(int(n), self.t_real))
        return min(n_out, self.t_loc), n_out

    def sim(self, qc) -> ShardedTensor:
        """[Q, t_pad] similarity, column-sharded over the mesh (whole on
        process 0 of a mesh across processes)."""
        return self._sim_tensor(self._local(qc, None))

    def sim_host(self, qc) -> np.ndarray:
        """[Q, t_real] similarity gathered to the host."""
        return np.asarray(self.sim(qc))[:, :self.t_real]

    def topk(self, qc, n: int):
        """([Q, n'], [Q, n']) top values + GLOBAL indices on this process's
        first device."""
        n_local, n_out = self._sizes(n)
        return self._merge(self._local(qc, n_local), n_out)

    def sim_and_topk(self, qc, n: int):
        """(sim [Q, t_pad] as ``sim`` gives it, vals, idx) from one GEMM per
        shard."""
        n_local, n_out = self._sizes(n)
        local = self._local(qc, n_local)
        return (self._sim_tensor(local),) + self._merge(local, n_out)


def pod_timeout(timeout_s: Optional[float] = None) -> Optional[float]:
    """The pod watchdog's deadline in seconds: ``timeout_s``, else
    ``SEEKR_TPU_POD_TIMEOUT`` (default 300); 0 or less turns the watchdog and
    the heartbeat off (None)."""
    if timeout_s is None:
        env = os.environ.get("SEEKR_TPU_POD_TIMEOUT", "300")
        try:
            timeout_s = float(env)
        except ValueError:
            raise ValueError(
                f"SEEKR_TPU_POD_TIMEOUT must be a number of seconds "
                f"(0 disables the watchdog), got {env!r}") from None
    return float(timeout_s) if timeout_s > 0 else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PodScorer:
    """Serving over a mesh across processes: one leader, followers in lockstep.

    Every process must enter every collective of a call, in the same order, or
    the pod deadlocks; a single-process accept loop cannot drive that.  So
    ``PodScorer`` wraps :class:`ShardedScorer` with a control plane over the
    control group (``parallel.comm``), as seekr_tpu's (``dist.py:578-940``):

      * the LEADER (process 0) owns the client-facing API (ShardedScorer's
        signatures).  Before each call it broadcasts a fixed int64 header
        ``[op, rows, cols, n]`` and then the float32 payload (the normalized
        query counts, or the standardized rows of a grow), then takes part in
        the call;
      * FOLLOWERS sit in :meth:`follow`, receive each (header, payload) pair
        and take part in the SAME call with the SAME arguments.

    ``sim`` gathers every process's column slabs to the leader, which holds the
    whole [Q, t_pad] product (the followers send their slabs and receive none); the top-k merges every process's candidates;
    ``grow`` re-shards the same corpus everywhere and votes on the outcome;
    ``stop`` releases the followers (server shutdown).  Calls must be
    serialized on the leader (SeekrService's device lock does it): the
    broadcast channel is ordered, not multiplexed.

    Liveness: a dead or stuck process would block the others in a collective.
    Every call (and the follower's mirror of it) runs under a watchdog of
    ``timeout_s`` (``pod_timeout``: SEEKR_TPU_POD_TIMEOUT, default 300 s; 0
    turns it off), which must exceed the longest legitimate call (warm up
    before serving).  On expiry, or when a collective fails in the transport
    (a peer's connection closed), the pod latches DEAD: the call raises an
    error naming the unresponsive participant, every later call raises at
    once, and ``stop()`` does nothing (a broadcast into a dead pod would hang
    the shutdown).  A stuck thread cannot be cancelled, so the latch keeps
    anything else from entering a collective; restart the pod to recover.
    """

    _OP_STOP, _OP_SIM, _OP_TOPK, _OP_SIM_TOPK, _OP_GROW, _OP_PING = range(6)

    def __init__(self, mesh: Mesh, targets_std, row_quantum: int = 1,
                 timeout_s: Optional[float] = None):
        self.mesh = mesh
        self.is_leader = comm.process_index() == 0
        self._stopped = False
        self._dead = False
        self._hb_thread = None
        self.timeout_s = pod_timeout(timeout_s)
        self._scorer = ShardedScorer(mesh, targets_std, row_quantum=row_quantum)

    def _guarded(self, fn, what: str, deadline: Optional[float]):
        """Run one pod operation, its collectives included, to completion
        within ``deadline`` seconds (None: no watchdog)."""
        if self._dead:
            raise RuntimeError(
                "pod is dead (a previous operation found a participant process "
                "unresponsive); restart the pod processes")
        box: dict = {}

        def run():
            try:
                box["v"] = fn()
            except BaseException as e:  # noqa: BLE001 -- raised below, in the caller
                box["e"] = e

        if deadline is None:
            run()
        else:
            t = threading.Thread(target=run, daemon=True, name=f"pod-{what}")
            t.start()
            t.join(deadline)
            if t.is_alive():
                self._dead = True
                raise RuntimeError(
                    f"pod {what} did not complete within {deadline:g}s: a participant "
                    "process is unresponsive (killed process / network partition).  The "
                    "pod is marked dead: every further request fails fast; restart all "
                    "pod processes to recover.")
        if "e" in box:
            err = box["e"]
            if isinstance(err, comm.CollectiveError):
                self._dead = True
                raise RuntimeError(
                    f"pod {what} failed in a collective: a participant process is "
                    "unresponsive (its connection closed).  The pod is marked dead: "
                    "every further request fails fast; restart all pod processes to "
                    f"recover.  ({err})") from err
            raise err
        return box["v"]

    def _with_deadline(self, fn, what: str):
        return self._guarded(fn, what, self.timeout_s)

    def heartbeat_start(self, lock, interval: Optional[float] = None):
        """Leader-side liveness beacon.

        Every ``interval`` (default timeout_s / 3, at least 1 s) the leader
        broadcasts a payload-free PING under the SAME lock that serializes
        device calls, so it never interleaves with one.  Followers bound their
        idle wait on it (``follow``'s ``header_timeout``) and so find a dead
        leader; a dead follower is found within one interval even on an idle
        service (the PING itself runs under the watchdog).  Idempotent; a no-op
        on followers and with the watchdog off."""
        if not self.is_leader or self._hb_thread is not None:
            return
        if interval is None and self.timeout_s is None:
            return  # watchdog disabled: liveness is off by choice
        interval = float(interval or max(1.0, self.timeout_s / 3.0))

        def loop():
            while True:
                time.sleep(interval)
                if self._stopped or self._dead:
                    return
                with lock:
                    if self._stopped or self._dead:
                        return
                    try:
                        self._with_deadline(lambda: self._bcast(np.array(
                            [self._OP_PING, 0, 0, 0], np.int64)), "heartbeat")
                    except BaseException as e:  # noqa: BLE001 -- reported, latched
                        # a broadcast that failed may have reached some followers
                        # only, so the ordered channel is not trusted any more;
                        # loudly: on an idle service only the beacon notices
                        print("seekr_tpu_torch pod: heartbeat failed, pod latched DEAD "
                              f"({type(e).__name__}: {str(e)[:200]}); restart all pod "
                              "processes", file=sys.stderr, flush=True)
                        self._dead = True
                        return

        self._hb_thread = threading.Thread(target=loop, daemon=True, name="pod-heartbeat")
        self._hb_thread.start()

    # the ShardedScorer surface the service reads
    @property
    def t_real(self) -> int:
        return self._scorer.t_real

    @property
    def t_loc(self) -> int:
        return self._scorer.t_loc

    @property
    def n_cols(self) -> int:
        return self._scorer.n_cols

    @property
    def host_corpus(self) -> np.ndarray:
        return self._scorer.host_corpus

    @property
    def n_dev(self) -> int:
        return self._scorer.n_dev

    def prospective_rows(self, new_total: int) -> int:
        return self._scorer.prospective_rows(new_total)

    @staticmethod
    def _bcast(arr: np.ndarray) -> np.ndarray:
        """The leader's ``arr``, received into every follower's ``arr``."""
        return comm.broadcast_from(torch.from_numpy(np.ascontiguousarray(arr))).numpy()

    def _announce(self, op: int, payload: np.ndarray, n: int) -> np.ndarray:
        if self._stopped:
            # STOP released the followers: a further broadcast would block in a
            # collective with no participants; fail the request instead
            raise RuntimeError("pod scorer is stopped: the followers have been released")
        self._bcast(np.array([op, payload.shape[0], payload.shape[1], n], dtype=np.int64))
        return self._bcast(payload)

    def _run(self, op: int, what: str, payload, n: int, call):
        q = np.ascontiguousarray(_host_f32(payload))

        def run():
            out = call(self._announce(op, q, n))
            _sync(self.mesh.first)
            return out

        return self._with_deadline(run, what)

    def sim(self, qc) -> ShardedTensor:
        """[Q, t_pad] similarity, whole on the leader (the slabs gathered)."""
        return self._run(self._OP_SIM, "sim", qc, 0,
                         lambda q: self._scorer.sim(q))

    def sim_host(self, qc) -> np.ndarray:
        return np.asarray(self.sim(qc))[:, :self.t_real]

    def topk(self, qc, n: int):
        return self._run(self._OP_TOPK, "topk", qc, int(n),
                         lambda q: self._scorer.topk(q, int(n)))

    def sim_and_topk(self, qc, n: int):
        return self._run(self._OP_SIM_TOPK, "sim_and_topk", qc, int(n),
                         lambda q: self._scorer.sim_and_topk(q, int(n)))

    def grow(self, new_std) -> int:
        """Broadcast the standardized new rows; every process re-shards the
        same grown corpus, then all AGREE on the outcome (``_grow_agreed``)."""
        return self._run(self._OP_GROW, "grow", new_std, 0, self._grow_agreed)

    def _grow_agreed(self, rows: np.ndarray) -> int:
        """A local grow can fail on one process only (its memory), and a t_real
        that differs between processes would give every later call mismatched
        collectives.  So every process votes its outcome (``all_gather_flags``);
        unless all succeeded, the ones that grew re-shard back to the old
        corpus and the call raises everywhere: the pod stays consistent."""
        old = self._scorer.host_corpus
        err = None
        try:
            self._scorer.grow(rows)
        except Exception as e:  # noqa: BLE001 -- the outcome is voted below
            err = e
        flags = comm.all_gather_flags(err is None)
        if not flags.all():
            if err is None:  # we grew but a peer failed: unwind
                self._scorer.reload(old)
            raise err if err is not None else RuntimeError(
                f"corpus grow failed on {int((~flags).sum())} process(es); every "
                "process restored the old corpus")
        return self._scorer.t_real

    def stop(self) -> None:
        """Release the followers.  Idempotent: a second call broadcasts nothing
        (STOP with no listeners would block forever), and every later call
        raises instead of hanging.  On a DEAD pod it does nothing."""
        if self._stopped or self._dead:
            self._stopped = True
            return
        try:
            self._with_deadline(lambda: self._bcast(np.array(
                [self._OP_STOP, 0, 0, 0], dtype=np.int64)), "stop")
        except RuntimeError:
            pass  # an unresponsive pod: nothing left to release
        finally:
            # latched whatever happened: a failed broadcast may have reached some
            # followers, and a retried STOP must not broadcast into a collective
            # with missing participants
            self._stopped = True

    def follow(self, header_timeout: Optional[float] = None) -> None:
        """Follower loop: mirror every leader call until STOP.

        A failed call is contained: the leader survives a failed request at
        its handler, so the follower must survive the mirrored failure too (a
        dead follower would wedge every later broadcast).  GROW runs the same
        vote as the leader.  Once a header lands, the payload and the mirrored
        call run under the watchdog: a leader that dies mid-call releases this
        process within ``timeout_s``.  The IDLE wait for the next header is
        bounded by ``header_timeout`` (the service passes 3 x timeout_s, about
        9 heartbeat intervals; None waits without bound), so a dead leader
        releases it too.  Raises RuntimeError when the pod is found dead.
        """
        first = self.mesh.first
        while True:
            hdr = self._guarded(lambda: self._bcast(np.zeros(4, np.int64)),
                                "follow(header: no leader heartbeat)", header_timeout)
            op, rows, cols, n = (int(v) for v in hdr)
            if op == self._OP_STOP:
                self._stopped = True
                return
            if op == self._OP_PING:
                continue  # the leader's liveness beacon: no payload, no work
            if op not in (self._OP_SIM, self._OP_TOPK, self._OP_SIM_TOPK, self._OP_GROW):
                raise RuntimeError(f"pod protocol: unknown op {op}")

            def step(op=op, rows=rows, cols=cols, n=n):
                payload = self._bcast(np.zeros((rows, cols), np.float32))
                if op == self._OP_SIM:
                    self._scorer.sim(payload)
                elif op == self._OP_TOPK:
                    self._scorer.topk(payload, n)
                elif op == self._OP_SIM_TOPK:
                    self._scorer.sim_and_topk(payload, n)
                else:
                    self._grow_agreed(payload)
                _sync(first)

            try:
                self._with_deadline(step, f"follow(op={op})")
            except Exception:  # noqa: BLE001 -- stay alive for the pod
                if self._dead:
                    raise  # the leader is unresponsive
                # a mirrored per-call failure; the leader reported it


def make_sharded_scorer(mesh: Mesh, targets_std, row_quantum: int = 1):
    """Serving scorer for a row-sharded corpus: a :class:`ShardedScorer` for a
    mesh in one process, a :class:`PodScorer` (the leader/follower protocol)
    for a mesh across processes."""
    if mesh.spans_processes:
        return PodScorer(mesh, targets_std, row_quantum=row_quantum)
    return ShardedScorer(mesh, targets_std, row_quantum=row_quantum)
