"""The seekr pipeline over a device mesh in one process.

Port of the single-host half of ``seekr_tpu/parallel/dist.py``.  Three kinds of
parallelism (the reference has none):

  * data parallel -- transcripts sharded over the 'data' axis; the column
    mean/std are reductions of per-shard partial sums;
  * kmer parallel -- the 4^k histogram columns sharded over 'kmer'; the Pearson
    Gram is the sum over kmer shards of partial products;
  * sequence parallel -- one very long transcript split into position chunks
    with a (k-1)-base halo; the integer partial histograms are summed.

seekr_tpu lets GSPMD insert the collectives from sharding annotations.  Here
each step is written out: the per-shard work is launched on each shard's
device (``count_graph``: the CUDA kernels on a card), and the partial results
are moved to one device and reduced there in a fixed shard order, so a run is
deterministic whatever the mesh's devices are.  ``_mesh_compatible``
(seekr_tpu ``dist.py:237-256``) works around a JAX placement rule and has no
counterpart: a tensor here moves with ``.to(device)``.

Serving over a mesh: ``ShardedScorer`` (the two-stage top-k) and
``make_sharded_scorer``.  The multi-host half (``PodScorer``, a
``torch.distributed`` bootstrap) comes with the port's slice 9;
``init_distributed`` raises for more than one process.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from seekr_tpu_torch.ops.count import count_graph, split_long_digits
from seekr_tpu_torch.ops.math import accurate_log2
from seekr_tpu_torch.ops.normalize import LOG2_POST, LOG2_PRE, check_log2_mode
from seekr_tpu_torch.ops.pearson import _row_standardize, as_float32, divide, gram, matmul_nt
from seekr_tpu_torch.parallel.mesh import (DATA_AXIS, KMER_AXIS, MULTI_HOST, Mesh,
                                           NamedSharding, Shard, ShardedTensor,
                                           pad_to_shards, replicated, shard,
                                           shard_index)


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """No-op for one process; more than one raises (slice 9 of the port)."""
    if num_processes is None or num_processes <= 1:
        return
    raise NotImplementedError(f"num_processes={num_processes}: {MULTI_HOST}")


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

    Data shard i (rows ``i * M/n_data`` onwards) is counted once, by
    ``count_graph`` on ``mesh.devices[i, 0]``: the CUDA kernel on a card, the
    plain version on the CPU.  seekr_tpu counts it again on every kmer replica
    (``dist.py:60-66``) for the same numbers; the pipeline sends each column
    slice to its kmer device instead.  Returns the per-shard count tensors.
    """
    m_loc = _check_rows(mesh, int(bases.shape[0]))
    out = []
    for i in range(mesh.shape[DATA_AXIS]):
        dev = mesh.devices[i, 0]
        rows = slice(i * m_loc, (i + 1) * m_loc)
        out.append(count_graph(_on(bases[rows], dev, torch.int8),
                               _on(lengths[rows], dev, torch.int32), k, flat=flat))
    return out


def _column_split(mesh: Mesh, per_row):
    """Grid [i][j] of data shard i's column slice j on ``mesh.devices[i, j]``
    (for an unflattened count tensor, a slice of n_hi)."""
    n_kmer = mesh.shape[KMER_AXIS]
    grid = []
    for i, x in enumerate(per_row):
        step = x.shape[1] // n_kmer
        grid.append([x[:, j * step:(j + 1) * step].to(mesh.devices[i, j])
                     for j in range(n_kmer)])
    return grid


def _column_totals(mesh: Mesh, grid, m_total: int):
    """Per column slice j: the sum over data shards of each shard's column sums,
    on ``mesh.devices[0, j]`` in shard order, divided by ``m_total``."""
    totals = []
    for j in range(mesh.shape[KMER_AXIS]):
        dev = mesh.devices[0, j]
        acc = None
        for row in grid:
            part = row[j].sum(dim=0).to(dev)
            acc = part if acc is None else acc + part
        totals.append(divide(acc, m_total))
    return totals


def _broadcast(mesh: Mesh, vecs):
    """Grid [i][j] of ``vecs[j]`` on each ``mesh.devices[i, j]``."""
    return [[vecs[j].to(mesh.devices[i, j]) for j in range(len(vecs))]
            for i in range(mesh.shape[DATA_AXIS])]


def _column_mean_std(mesh: Mesh, grid, m_total: int):
    """Column mean and the two-pass POPULATION std of ``grid``, as ``jnp.mean``
    and ``jnp.std``: the mean first, then the mean of squared deviations from
    it (never E[x^2] - E[x]^2)."""
    mean = _column_totals(mesh, grid, m_total)
    mean_b = _broadcast(mesh, mean)
    sq = [[(x - mu) ** 2 for x, mu in zip(row, mus)] for row, mus in zip(grid, mean_b)]
    std = [torch.sqrt(v) for v in _column_totals(mesh, sq, m_total)]
    return mean, std


def _global_min(mesh: Mesh, grid) -> torch.Tensor:
    """min over every shard on the first device; ``torch.minimum`` carries a NaN
    as ``jnp.min`` does (Python's ``min`` would not)."""
    acc = None
    for row in grid:
        for x in row:
            part = x.amin().to(mesh.first)
            acc = part if acc is None else torch.minimum(acc, part)
    return acc


def _row_standardize_sharded(mesh: Mesh, grid, n_cols: int):
    """``ops.pearson._row_standardize`` of rows whose columns are split over
    the kmer axis: each row's sums run over its kmer shards, reduced on
    ``mesh.devices[i, 0]``."""
    out = []
    for i, row in enumerate(grid):
        home = mesh.devices[i, 0]

        def row_mean(parts):
            acc = None
            for x in parts:
                s = x.reshape(x.shape[0], -1).sum(dim=1).to(home)
                acc = s if acc is None else acc + s
            return divide(acc, n_cols)

        def per_shard(v, x):
            return v.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))

        mu = row_mean(row)
        c = [x - per_shard(mu, x) for x in row]
        mu2 = row_mean(c)  # the std is taken around the centered rows' own mean
        sd = torch.sqrt(row_mean([(x - per_shard(mu2, x)) ** 2 for x in c]))
        out.append([x / per_shard(sd, x) for x in c])
    return out


def _sharded_gram(mesh: Mesh, z, n_cols: int):
    """Per data shard i: ``z_i @ Z^T / n_cols`` with Z the standardized rows of
    every shard; the Gram is the sum over kmer shards j of partial
    ``[M_loc, M]`` products (``ops.pearson.gram``) against column slice j
    gathered over 'data', added on ``mesh.devices[i, 0]`` in shard order."""
    n_data, n_kmer = mesh.shape[DATA_AXIS], mesh.shape[KMER_AXIS]
    flat = [[x.reshape(x.shape[0], -1) for x in row] for row in z]
    right = {}  # (j, device) -> column slice j of every row, on that device
    sims = []
    for i in range(n_data):
        home = mesh.devices[i, 0]
        acc = None
        for j in range(n_kmer):
            dev = mesh.devices[i, j]
            key = (j, str(dev))
            if key not in right:
                right[key] = torch.cat([flat[r][j].to(dev) for r in range(n_data)])
            part = gram(flat[i][j], right[key]).to(home)
            acc = part if acc is None else acc + part
        sims.append(divide(acc, n_cols))
    return sims


def _grid_tensor(mesh: Mesh, shape, spec, grid) -> ShardedTensor:
    sharding = NamedSharding(mesh, spec)
    shards = [Shard(mesh.devices[i, j], shard_index(sharding, shape, (i, j)), grid[i][j])
              for i in range(mesh.shape[DATA_AXIS]) for j in range(mesh.shape[KMER_AXIS])]
    return ShardedTensor(shape, grid[0][0].dtype, sharding, shards)


def _vector_slices(mesh: Mesh, v, trailing):
    """A provided flat [4^k] norm vector cut into the mesh's column slices, each
    on ``mesh.devices[0, j]`` in the count tensor's trailing shape (float64
    .npy vectors are cast, as seekr_tpu does, so they do not promote the
    chain)."""
    n_kmer = mesh.shape[KMER_AXIS]
    v = torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v))
    parts = v.reshape(-1).reshape(n_kmer, -1)
    return [parts[j].to(device=mesh.devices[0, j], dtype=torch.float32).reshape(trailing)
            for j in range(n_kmer)]


def _kmer_vector(mesh: Mesh, vecs) -> ShardedTensor:
    """Per-kmer-slice vectors as one flat [4^k] vector sharded over 'kmer'."""
    flat = [v.reshape(-1) for v in vecs]
    shape = (sum(v.shape[0] for v in flat),)
    return _grid_tensor(mesh, shape, (KMER_AXIS,), _broadcast(mesh, flat))


def _pipeline_fn(mesh: Mesh, bases, lengths, mean, std, k: int, log2: str, flat: bool):
    """Encoded bases -> (normalized counts, mean, std, Pearson) on the mesh.

    The epilogue is ``models/pipeline``'s normalize chain with its three
    global reductions written out: the column mean and std over 'data', the
    Log2.post ``min`` over every shard, and the Pearson row standardization
    over 'kmer'.
    """
    n_data, n_kmer = mesh.shape[DATA_AXIS], mesh.shape[KMER_AXIS]
    raw = _sharded_count(mesh, bases, lengths, k, flat=flat)
    if not flat and raw[0].shape[1] % n_kmer:
        raise ValueError(
            f"flat=False shards the 3-D count tensor's n_hi axis "
            f"(= {raw[0].shape[1]} for k={k} under the current count "
            f"implementation) over the {n_kmer}-device kmer axis, "
            f"which requires divisibility; use flat=True (4^k columns "
            f"shard much finer) or a smaller kmer_parallel.")
    m_total, n_cols = int(bases.shape[0]), 4 ** k
    x = _column_split(mesh, raw)
    del raw
    if log2 == LOG2_PRE:
        x = [[accurate_log2(c + 1.0) for c in row] for row in x]
    trailing = x[0][0].shape[1:]
    if mean is None:
        mean_v = _column_totals(mesh, x, m_total)
    else:
        mean_v = _vector_slices(mesh, mean, trailing)
    x = [[c - mu for c, mu in zip(row, mus)] for row, mus in zip(x, _broadcast(mesh, mean_v))]
    std_v = (_column_mean_std(mesh, x, m_total)[1] if std is None
             else _vector_slices(mesh, std, trailing))
    x = [[c / sd for c, sd in zip(row, sds)] for row, sds in zip(x, _broadcast(mesh, std_v))]
    if log2 == LOG2_POST:
        shift = _global_min(mesh, x).abs()
        x = [[accurate_log2(c + shift.to(c.device) + 1.0) for c in row] for row in x]

    sims = _sharded_gram(mesh, _row_standardize_sharded(mesh, x, n_cols), n_cols)
    shape = (m_total,) + tuple(int(s) * (n_kmer if d == 0 else 1)
                               for d, s in enumerate(trailing))
    spec = (DATA_AXIS, KMER_AXIS) + (None,) * (len(trailing) - 1)
    normalized = _grid_tensor(mesh, shape, spec, x)
    sim = _grid_tensor(mesh, (m_total, m_total), (DATA_AXIS, None),
                       [[s.to(mesh.devices[i, j]) for j in range(n_kmer)]
                        for i, s in enumerate(sims)])
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
    by the data-axis size.

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
    """
    check_log2_mode(log2)

    def step(bases, lengths):
        raw = _sharded_count(mesh, bases, lengths, k)
        if log2 == LOG2_PRE:
            raw = [accurate_log2(x + 1.0) for x in raw]
        grid = [[x] for x in raw]  # full columns on each data shard's device
        mean, std = _column_mean_std(mesh, grid, int(bases.shape[0]))
        return (shard(mean[0].to(mesh.first), replicated(mesh)),
                shard(std[0].to(mesh.first), replicated(mesh)))

    return step


def count_long_sequence(mesh: Mesh, k: int):
    """Sequence-parallel counting of ONE long transcript.

    Returns a function (chunks [n_dev, chunk + k - 1] int8, n_windows) -> [4^k]
    float32 counts per kb on the mesh's first device.  Device d of the mesh
    (row-major) counts chunk d with its halo, unscaled, through ``count_graph``;
    the integer partials are summed (exact in any order), then scaled as
    seekr_tpu does here: by the float32 quotient ``1000 / float32(n_windows)``,
    zeros when ``n_windows <= 0``.
    """
    devices = list(mesh.devices.flat)

    def step(chunks, n_windows):
        if int(chunks.shape[0]) != len(devices):
            raise ValueError(f"{chunks.shape[0]} chunks for a {len(devices)}-device mesh "
                             "(shard_long_sequence(digits, k, mesh.size))")
        total = None
        for d, dev in enumerate(devices):
            chunk = _on(chunks[d:d + 1], dev, torch.int8)
            width = torch.tensor([chunk.shape[1]], dtype=torch.int32, device=dev)
            part = count_graph(chunk, width, k, scaled=False)[0].to(mesh.first)
            total = part if total is None else total + part
        nw = torch.tensor(float(np.float32(n_windows)), dtype=torch.float32,
                          device=mesh.first)
        num = torch.tensor(1000.0, dtype=torch.float32, device=mesh.first)
        # a transcript shorter than k has no windows: zeros, not 0 * inf = NaN
        scale = torch.where(nw > 0, num / nw, torch.zeros_like(nw))
        return total * scale

    return step


def _standardized_shards(counts, devices, m_pad: int):
    """Row shards of the row-standardized ``counts``, one per device, zero rows
    padded in AFTER standardizing (the pad never reaches a writer)."""
    m = int(counts.shape[0])
    m_loc = m_pad // len(devices)
    out = []
    for d, dev in enumerate(devices):
        lo, hi = min(d * m_loc, m), min((d + 1) * m_loc, m)
        part = torch.zeros((m_loc, int(counts.shape[1])), dtype=torch.float32, device=dev)
        if hi > lo:
            part[:hi - lo] = _row_standardize(as_float32(counts[lo:hi], dev))
        out.append(part)
    return out


def _gather_rows(shards, start: int, rows: int, device) -> torch.Tensor:
    """Rows [start, start + rows) of equal row shards, on ``device``."""
    m_loc = shards[0].shape[0]
    parts = []
    for d in range(start // m_loc, (start + rows - 1) // m_loc + 1):
        lo = max(start, d * m_loc) - d * m_loc
        hi = min(start + rows, (d + 1) * m_loc) - d * m_loc
        parts.append(shards[d][lo:hi].to(device))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def stream_pearson_sharded(mesh: Mesh, counts, writer, block_rows: int = 4096,
                           counts2=None):
    """All-pairs Pearson of data-sharded count matrices, streamed to the host.

    For m large enough that the [m1, m2] r-matrix fits no single device: both
    matrices are row-standardized and held as row shards over 'data'
    (``mesh.devices[i, 0]``), zero rows padded in after standardizing so row
    counts need not divide the axis.  Each left block of ``block_rows`` rows is
    copied to every data device, each device computes its column slice of the
    [block, m2] tile (``ops.pearson.matmul_nt``), and the slices are put
    together on the host in shard order and appended to ``writer``, at most one
    tile at a time.  ``counts2=None`` streams the self-similarity; otherwise
    rows come from ``counts`` and columns from ``counts2``.  The last block is
    taken whole and clamped to the padded edge, as seekr_tpu's
    ``dynamic_slice`` does, so every tile has one shape.
    """
    n_data = mesh.shape[DATA_AXIS]
    devices = [mesh.devices[i, 0] for i in range(n_data)]
    m1 = int(counts.shape[0])
    m2 = m1 if counts2 is None else int(counts2.shape[0])
    m1_pad = pad_to_shards(m1, n_data)
    left = _standardized_shards(counts, devices, m1_pad)
    right = left if counts2 is None else _standardized_shards(
        counts2, devices, pad_to_shards(m2, n_data))
    block = min(block_rows, m1_pad)
    for start in range(0, m1, block):
        end = min(start + block, m1)
        clamped = min(start, m1_pad - block)
        off = start - clamped
        blocks = {}  # one copy of the left block per distinct device
        tiles = []
        for dev, r in zip(devices, right):
            if str(dev) not in blocks:
                blocks[str(dev)] = _gather_rows(left, clamped, block, dev)
            tiles.append(matmul_nt(blocks[str(dev)], r))
        tile = np.concatenate([t.cpu().numpy() for t in tiles], axis=1)
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
    (row-major over the grid), so a corpus too big for one card lives as ~T/D
    rows per device.  Three entry points, each one shard-local GEMM per device:

      * ``sim(qc) -> [Q, t_pad]`` similarity as a ``ShardedTensor``
        column-sharded over the mesh; columns >= ``t_real`` are pad
        (``sim_host`` gathers and slices).  Queries are row-standardized once,
        on the first device.
      * ``topk(qc, n) -> ([Q, n'] values, [Q, n'] GLOBAL indices)``, n' =
        min(n, T), on the first device: a two-stage top-k.  Each shard masks
        its pad rows to -inf by global row id and keeps [Q, min(n', t_loc)]
        candidates by a stable descending sort; the merge sorts the candidates,
        in device order, stably by value.  Equal values therefore go to the
        lower global index, as ``lax.top_k`` over device-ordered candidates
        does.
      * ``sim_and_topk(qc, n) -> (sim, vals, idx)`` from one GEMM per shard.

    A grow within the quantum keeps every shard's shape, so cuBLAS keeps its
    kernel and every existing score stays the same bit for bit.
    """

    def __init__(self, mesh: Mesh, targets_std, row_quantum: int = 1):
        self.mesh = mesh
        self.devices = list(mesh.devices.flat)
        self.n_dev = int(mesh.size)
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
        """(Re)place the corpus shards from the host copy."""
        self.t_real, self.n_cols = (int(d) for d in host.shape)
        self.t_loc = self.prospective_rows(self.t_real) // self.n_dev
        shards = []
        for d, dev in enumerate(self.devices):
            part = host[d * self.t_loc:(d + 1) * self.t_loc]
            t = torch.zeros((self.t_loc, self.n_cols), dtype=torch.float32, device=dev)
            if len(part):
                t[:len(part)] = torch.from_numpy(np.ascontiguousarray(part)).to(dev)
            shards.append(t)
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
        """Re-shard from an explicit host corpus."""
        host = _host_f32(host)
        self._shards = None
        self._load(host)
        self._host = host

    @property
    def host_corpus(self) -> np.ndarray:
        """The unpadded [t_real, n_cols] standardized corpus on the host: the
        grow shadow, which a service snapshot reads instead of the devices."""
        return self._host

    def _local(self, qc, n_local: Optional[int]):
        """Per device: the [Q, t_loc] shard-local GEMM, and with ``n_local`` its
        (values, global ids) of the best ``n_local`` real rows."""
        q = _row_standardize(as_float32(qc, self.mesh.first))
        queries = {}
        out = []
        for d, (dev, t) in enumerate(zip(self.devices, self._shards)):
            if str(dev) not in queries:
                queries[str(dev)] = q.to(dev)
            sim = matmul_nt(queries[str(dev)], t)
            if n_local is None:
                out.append((sim, None, None))
                continue
            gid = d * self.t_loc + torch.arange(self.t_loc, dtype=torch.int32, device=dev)
            masked = sim.masked_fill((gid >= self.t_real)[None, :], float("-inf"))
            vals, pos = torch.sort(masked, dim=1, descending=True, stable=True)
            out.append((sim, vals[:, :n_local], gid[pos[:, :n_local]]))
        return out

    def _sim_tensor(self, local) -> ShardedTensor:
        shape = (local[0][0].shape[0], self.t_loc * self.n_dev)
        shards = [Shard(dev, shard_index(self._sharding, shape, (d // self.mesh.shape[KMER_AXIS],
                                                                 d % self.mesh.shape[KMER_AXIS])),
                        sim)
                  for d, (dev, (sim, _, _)) in enumerate(zip(self.devices, local))]
        return ShardedTensor(shape, torch.float32, self._sharding, shards)

    def _merge(self, local, n_out: int):
        first = self.mesh.first
        cand_v = torch.cat([v.to(first) for _, v, _ in local], dim=1)
        cand_i = torch.cat([i.to(first) for _, _, i in local], dim=1)
        vals, pos = torch.sort(cand_v, dim=1, descending=True, stable=True)
        return vals[:, :n_out], torch.gather(cand_i, 1, pos[:, :n_out])

    def _sizes(self, n: int):
        n_out = max(1, min(int(n), self.t_real))
        return min(n_out, self.t_loc), n_out

    def sim(self, qc) -> ShardedTensor:
        """[Q, t_pad] similarity, column-sharded over the mesh."""
        return self._sim_tensor(self._local(qc, None))

    def sim_host(self, qc) -> np.ndarray:
        """[Q, t_real] similarity gathered to the host."""
        return np.asarray(self.sim(qc))[:, :self.t_real]

    def topk(self, qc, n: int):
        """([Q, n'], [Q, n']) top values + GLOBAL indices on the first device."""
        n_local, n_out = self._sizes(n)
        return self._merge(self._local(qc, n_local), n_out)

    def sim_and_topk(self, qc, n: int):
        """(sim [Q, t_pad] column-sharded, vals, idx) from one GEMM per shard."""
        n_local, n_out = self._sizes(n)
        local = self._local(qc, n_local)
        return (self._sim_tensor(local),) + self._merge(local, n_out)


def make_sharded_scorer(mesh: Mesh, targets_std, row_quantum: int = 1) -> ShardedScorer:
    """Serving scorer for a row-sharded corpus.  The mesh lives in one process,
    so this is a :class:`ShardedScorer`; seekr_tpu's ``PodScorer`` for a mesh
    across processes comes with the port's slice 9."""
    return ShardedScorer(mesh, targets_std, row_quantum=row_quantum)
