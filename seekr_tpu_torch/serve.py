"""Warm-resident similarity service on one CUDA card.

Port of ``seekr_tpu/serve.py`` for a single device.  A resident process loads
the background once and answers many small query batches:

    svc = SeekrService(mean="mean.npy", std="std.npy", k=6,
                       targets="gencode.fa", fitres=fitres)
    svc.warmup()
    out = svc.query(["AGTC...", ...], want=("sim", "pvals"))

Each query runs count (the CUDA histogram) -> the normalize epilogue -> one
float32 GEMM against the resident, row-standardized targets -> optionally a
top-k on the card; only ``[Q, T]`` (or ``[Q, topk]``) crosses to the host.

``serve_forever`` exposes the service over a UNIX domain socket with the
newline-delimited JSON protocol of seekr_tpu (same requests, same responses):

    {"seqs": [...], "want": ["sim", "pvals"]} -> {"ok": true, "sim": .., "m", "n"}
    {"seqs": [...], "want": ["topk", "topk_pvals"], "topk": 10}
        -> {"topk_sim", "topk_idx", "topk_names", "topk_pvals"}
    "outfile": "/prefix" writes <prefix>_sim.npy / <prefix>_pvals.npy instead
        (only under serve_forever(..., artifact_dir=DIR), confined to DIR)
    {"op": "ping" | "add_targets" | "save_corpus" | "shutdown"}

The socket is created owner-only (0600).  ``mesh=`` (a ``parallel.mesh.Mesh``)
row-shards the standardized targets over every mesh device and selects the
top-k in two stages (``parallel.dist.ShardedScorer``); pod serving across
processes (``follow``) comes with the port's slice 9.  torch is imported only
where the card is used, so a process that only calls ``request`` never imports
it.
"""

from __future__ import annotations

import collections
import json
import os
import socket
import socketserver
import tempfile
import threading
import time
from typing import Optional, Sequence

import numpy as np

_MAX_REQUEST = 256 << 20  # 256 MB of request line is a caller bug

# Batches up to this many rows take the serving single-bucket encode policy
# (see _seq_counter); larger ones are bulk loads and keep the length buckets.
_SINGLE_BUCKET_MAX_ROWS = 1024


def _topk(sim, limit: int, n: int, mask_cols: bool):
    """Top-``n`` values and indices of each row of ``sim`` on its device.

    Columns ``>= limit`` are masked to -inf when ``mask_cols``: in
    self-similarity mode they are the padded rows' copies, in targets mode the
    zero rows of the width quantum (sim 0, which would beat every negative
    correlation).  Ties go to the lower index, as in ``lax.top_k``:
    ``torch.topk`` orders ties arbitrarily on CUDA, so the row is sorted with a
    stable descending sort and its first ``n`` columns are kept.
    """
    import torch

    if mask_cols:
        cols = torch.arange(sim.shape[1], device=sim.device) >= limit
        sim = sim.masked_fill(cols, float("-inf"))
    vals, idx = torch.sort(sim, dim=1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


def _default_corpus_budget(device):
    """Half the card's memory (``torch.cuda.mem_get_info``); no default cap on
    the CPU.  The resident corpus shares the card with query batches and the
    ``[Q, T]`` output, so only a fraction is budgeted to it."""
    if device.type != "cuda":
        return None
    import torch

    return int(torch.cuda.mem_get_info(device)[1]) // 2


def _atomic_write(path: str, write_fn, suffix: str) -> None:
    """Write-then-rename: ``write_fn(fh)`` fills a temp file in the target's
    directory and ``os.replace`` publishes it, so a crash never leaves a
    truncated artifact and a symlink planted at ``path`` is replaced, not
    followed."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)), suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as fh:
            write_fn(fh)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _atomic_npy_save(path: str, arr: np.ndarray) -> None:
    _atomic_write(path, lambda fh: np.save(fh, arr), ".npy.tmp")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _PendingQuery:
    """One in-flight request in the coalescing queue (see query())."""

    __slots__ = ("seqs", "want", "topk", "done", "result", "error")

    def __init__(self, seqs, want, topk):
        self.seqs = seqs
        self.want = want
        self.topk = topk
        self.done = threading.Event()
        self.result = None
        self.error = None


class SeekrService:
    """Preloaded background on one card; thread-safe queries."""

    def __init__(self, mean, std, k: int = 6, log2: str = "Log2.post",
                 targets=None, fitres=None, coalesce: bool = True,
                 mesh=None, mem_budget_bytes=None, grow_quantum: int = 256,
                 device=None):
        """mean/std: .npy path or [4^k] array (the background norm vectors).
        targets: fasta path, list of sequences, or a ``save_corpus`` .npz;
        queries are scored against these (default: against the query batch
        itself).  fitres: find_dist output (fitted tuples or a raw r-value
        array) enabling "pvals".  coalesce: merge requests that arrive while
        the card is busy into one device batch (targets mode only).  mesh: a
        ``parallel.mesh.Mesh``; the standardized targets are row-sharded over
        every mesh device (~T/D rows each) and top-k is a two-stage selection
        (``parallel.dist.make_sharded_scorer``); it needs targets.

        mem_budget_bytes: cap on the resident corpus' device bytes (per device
        on a mesh); ``add_targets`` past it is refused.  Default: half the
        card's memory (SEEKR_TPU_CORPUS_BUDGET overrides; 0 disables the cap;
        no default cap on the CPU).

        grow_quantum: the resident corpus is padded with zero rows to a
        multiple of this many rows from the initial load, so a grow within the
        quantum writes rows in place and changes no shape: cuBLAS keeps its
        kernel, and existing targets' scores stay bitwise the same.  0/1
        disables it.  device: where queries are counted and normalized
        (``None`` = the mesh's first device with a mesh, else the first CUDA
        card)."""
        import torch

        from seekr_tpu_torch.ops.pearson import standardize_rows
        from seekr_tpu_torch.utils.device import resolve_device

        if mesh is not None and targets is None:
            raise ValueError("mesh serving requires targets: the sharded "
                             "corpus IS the thing being distributed")
        self.device = resolve_device(mesh.first if device is None and mesh is not None
                                     else device)
        self.k = int(k)
        self.log2 = log2
        self.mean = np.load(mean) if isinstance(mean, str) else np.asarray(mean)
        self.std = np.load(std) if isinstance(std, str) else np.asarray(std)
        if len(self.mean) != 4 ** self.k or len(self.std) != 4 ** self.k:
            raise ValueError(
                f"norm vectors must have 4^k = {4 ** self.k} entries for "
                f"k={self.k} (got {len(self.mean)}/{len(self.std)})")
        # uploaded once: every count and normalize of the service reads these
        self._mean_t = torch.as_tensor(self.mean, device=self.device).to(torch.float32)
        self._std_t = torch.as_tensor(self.std, device=self.device).to(torch.float32)
        self.fitres = fitres
        self._sorted_bkg = None  # lazily sorted empirical background
        self._lock = threading.Lock()
        self.coalesce = bool(coalesce)
        self.grow_quantum = max(1, int(grow_quantum))
        if mem_budget_bytes is None:
            env = os.environ.get("SEEKR_TPU_CORPUS_BUDGET")
            if env:
                try:
                    mem_budget_bytes = int(env)
                except ValueError:
                    raise ValueError(
                        f"SEEKR_TPU_CORPUS_BUDGET must be an integer byte "
                        f"count (0 disables the cap), got {env!r}") from None
                if mem_budget_bytes <= 0:
                    mem_budget_bytes = None  # 0 = unlimited, by convention
            else:
                mem_budget_bytes = _default_corpus_budget(self.device)
        self.mem_budget_bytes = mem_budget_bytes
        # one merged device batch never exceeds this many query rows; warmup()
        # sets it to the largest batch it covered
        self.max_coalesce_rows = 512
        self._queue: list = []
        self._queue_lock = threading.Lock()
        self.queries_served = 0
        self.device_batches = 0  # device passes actually run (telemetry)
        # client-observed latency (enqueue -> answer) of the last 1024 requests
        self._latencies = collections.deque(maxlen=1024)
        self._lat_lock = threading.Lock()

        # only the STANDARDIZED targets stay on the card: every query's Pearson
        # skips their re-standardization (bitwise the same GEMM operand)
        self.target_names = None
        self._targets_std = None
        self._scorer = None
        self._has_targets = targets is not None
        self._n_targets = 0
        if targets is not None:
            if isinstance(targets, str) and targets.endswith(".npz"):
                tstd, self.target_names = self._load_corpus(targets)
            elif isinstance(targets, str):
                counter = self._counter(targets)
                tstd = standardize_rows(counter.get_counts_device(nan_check=True),
                                        device=self.device)
                self.target_names = [h[1:] for h in counter.headers]
            else:
                tstd = standardize_rows(self._count(list(targets), nan_check=True),
                                        device=self.device)
                self.target_names = [f"t{i}" for i in range(len(targets))]
            self._n_targets = len(self.target_names)
            if mesh is not None:
                from seekr_tpu_torch.parallel.dist import make_sharded_scorer

                # one host crossing at load: the scorer lays out its shards from
                # a host copy and keeps it as the re-shard shadow for
                # add_targets (host RAM, not device memory)
                self._scorer = make_sharded_scorer(mesh, tstd,
                                                   row_quantum=self.grow_quantum)
            else:
                self._targets_std = self._quantize_pad(
                    torch.as_tensor(tstd, device=self.device))
            over = self._corpus_bytes_over(self._resident_rows())
            if over:
                print(f"seekr_tpu_torch serve: WARNING {over} -- queries may run "
                      "out of device memory; raise mem_budget_bytes or shard over "
                      "a mesh (-dp N)", flush=True)

    def _quantize_pad(self, tstd):
        """Pad a standardized target matrix with zero rows up to the next
        ``grow_quantum`` multiple (see __init__)."""
        import torch

        t = int(tstd.shape[0])
        padded = -(-t // self.grow_quantum) * self.grow_quantum
        if padded == t:
            return tstd
        return torch.cat([tstd, tstd.new_zeros((padded - t, tstd.shape[1]))])

    def _resident_rows(self) -> int:
        """Resident corpus rows, quantization pad included."""
        if self._scorer is not None:
            return self._scorer.t_loc * self._scorer.n_dev
        return int(self._targets_std.shape[0]) if self._targets_std is not None else 0

    def _corpus_bytes_over(self, rows_padded: int):
        """Budget check of a padded row count (per device on a mesh): a message
        with the measured numbers when over ``mem_budget_bytes``, None when
        within (or no cap)."""
        if self.mem_budget_bytes is None:
            return None
        n_dev = self._scorer.n_dev if self._scorer is not None else 1
        per_dev_rows = -(-rows_padded // n_dev)
        need = per_dev_rows * (4 ** self.k) * 4  # float32
        if need <= self.mem_budget_bytes:
            return None
        return (f"resident corpus would need {need:,} bytes/device "
                f"({per_dev_rows:,} rows x {4 ** self.k:,} cols x 4 B"
                f"{f' over {n_dev} devices' if n_dev > 1 else ''}), over "
                f"the {self.mem_budget_bytes:,}-byte corpus budget")

    def _load_corpus(self, path: str):
        """Load a ``save_corpus`` snapshot (of this package or seekr_tpu): the
        standardized target matrix + names, validated against THIS service's
        k, log2 and norm vectors, which the matrix depends on."""
        with np.load(path, allow_pickle=False) as z:
            missing = {"format", "tstd", "names", "k", "log2",
                       "mean", "std"} - set(z.files)
            if missing:
                raise ValueError(f"{path} is not a seekr_tpu corpus "
                                 f"snapshot (missing {sorted(missing)})")
            fmt = int(z["format"])
            if fmt != 1:
                raise ValueError(f"corpus snapshot format {fmt} is newer "
                                 "than this seekr_tpu_torch (supports 1)")
            if int(z["k"]) != self.k or str(z["log2"]) != self.log2:
                raise ValueError(
                    f"corpus snapshot was built with k={int(z['k'])}, "
                    f"log2={z['log2']}; this service runs k={self.k}, "
                    f"log2={self.log2}")
            if (not np.array_equal(z["mean"], self.mean)
                    or not np.array_equal(z["std"], self.std)):
                raise ValueError(
                    "corpus snapshot was standardized with DIFFERENT "
                    "norm vectors than this service's mean/std -- "
                    "rebuild the snapshot from the target fasta")
            tstd = np.asarray(z["tstd"], np.float32)
            names = [str(n) for n in z["names"]]
        if tstd.ndim != 2 or tstd.shape[1] != 4 ** self.k:
            raise ValueError(f"corpus snapshot matrix is {tstd.shape}, "
                             f"want [T, {4 ** self.k}]")
        if len(names) != tstd.shape[0]:
            raise ValueError(f"corpus snapshot has {tstd.shape[0]} rows "
                             f"but {len(names)} names")
        return tstd, names

    def save_corpus(self, path: str) -> str:
        """Write the resident corpus (with any ``add_targets`` growth, without
        the quantum's pad rows) as a restartable .npz snapshot, with the keys
        and checks of seekr_tpu's: either package loads the other's.  A service
        started with ``targets=<path>`` skips counting the target fasta and
        scores bitwise like this one.  Taken under the device lock."""
        if not self._has_targets:
            raise ValueError("service started without targets: "
                             "self-similarity mode has no corpus to save")
        if not path.endswith(".npz"):
            raise ValueError("corpus snapshot path must end in .npz")
        with self._lock:
            # only the real rows: the mesh's host shadow is unpadded
            host = (self._scorer.host_corpus if self._scorer is not None
                    else self._targets_std[:self._n_targets].cpu().numpy())
            names = np.asarray(self.target_names)
        _atomic_write(
            path,
            lambda fh: np.savez(fh, format=np.int64(1), tstd=host,
                                names=names, k=np.int64(self.k),
                                log2=np.asarray(self.log2),
                                mean=self.mean, std=self.std),
            ".npz.tmp")
        return path

    def follow(self) -> None:
        """Follower entry point of pod serving (one process per host), which
        comes with the port's slice 9: raises."""
        from seekr_tpu_torch.parallel.mesh import MULTI_HOST

        raise NotImplementedError(f"SeekrService.follow: {MULTI_HOST}")

    def stop_followers(self) -> None:
        """No-op: a mesh in one process has no followers to release."""

    def _counter(self, infasta=None):
        from seekr_tpu_torch.models.counter import KmerCounter

        return KmerCounter(infasta, k=self.k, mean=self._mean_t, std=self._std_t,
                           log2=self.log2, silent=True, device=self.device)

    def _seq_counter(self, seqs: Sequence[str]):
        """In-memory counter with the serving bucket policy: one length bucket,
        padded to the batch max (a power of two).

        A query batch then lands on one (rows, length) shape of the warmup grid
        whatever its length mix, and its count is one kernel launch.  Bulk
        loads (more than ``_SINGLE_BUCKET_MAX_ROWS`` rows) keep the length
        buckets, which move fewer bytes.  Counts are integer window sums, so
        the policy cannot change a value.
        """
        from seekr_tpu_torch.io.encode import pick_bucket_length
        from seekr_tpu_torch.models.counter import _LONG_SEQ_THRESHOLD

        counter = self._counter()
        counter.seqs = list(seqs)
        if len(counter.seqs) <= _SINGLE_BUCKET_MAX_ROWS:
            short_max = max((len(s) for s in counter.seqs
                             if len(s) <= _LONG_SEQ_THRESHOLD), default=0)
            if short_max:
                counter.min_bucket_len = pick_bucket_length(short_max, self.k)
        return counter

    def _count(self, seqs: Sequence[str], nan_check: bool = False):
        """Normalized counts of in-memory sequences, on the card.  The NaN
        probe waits for the card, so the query path skips it; loads use it."""
        return self._seq_counter(seqs).get_counts_device(nan_check=nan_check)

    def _count_raw(self, seqs: Sequence[str]):
        """Raw counts-per-kb on the card: the coalesced path normalizes them
        per segment itself."""
        return self._seq_counter(seqs)._raw_counts_device()

    @staticmethod
    def _pad_batch(seqs: Sequence[str]):
        """Pad a query batch to the next power of two with copies of its last
        sequence.

        Bounds the shapes the card sees to O(log max_batch).  The copies are
        sliced off every result.  Log2.post shifts by the batch's global min,
        which a duplicate row cannot move, so the real rows are unchanged
        (exact only with PROVIDED mean/std, which the service always has).
        """
        return list(seqs) + [seqs[-1]] * (_next_pow2(len(seqs)) - len(seqs))

    def warmup(self, lengths=(512, 1024, 2048), max_batch: int = 16,
               topk: int = 10) -> None:
        """Run every padded (rows, length) shape up to ``max_batch`` rows and
        ``max(lengths)`` bases, the top-k and the coalesced segmented grid once
        before traffic.

        The card has no executables to compile; what this buys is the kernel
        build, cuBLAS' choice for each GEMM shape and the caching allocator's
        blocks.  It also caps coalescing at the largest batch it covered.
        """
        with self._lock:
            self._warmup_locked(lengths, max_batch, topk)

    def _warmup_locked(self, lengths, max_batch, topk):
        from seekr_tpu_torch.ops.normalize import normalize_counts_segmented

        rng = np.random.default_rng(0)
        letters = np.array(list("AGTC"))
        sizes, b = [], 1
        while b <= max_batch:
            sizes.append(b)
            b *= 2
        for L in lengths:
            for q in sizes:
                seqs = ["".join(letters[rng.integers(0, 4, size=L)])
                        for _ in range(q)]
                qc = self._count(self._pad_batch(seqs))
                sim_dev = self._sim_device(qc)
                sim_dev[:1, :1].cpu()
                if topk:
                    if self._scorer is not None:  # topk-only and sim+topk
                        self._mesh_topk(qc, q, topk)
                        self._mesh_topk(qc, q, topk, with_sim=True)
                    else:
                        self._topk_device(sim_dev, q, topk)
        if self.coalesce and self._has_targets:
            # the largest merge is the largest batch ever warmed (a later
            # warmup with a larger max_batch raises the cap), never above the
            # cap set before the first warmup
            if not hasattr(self, "_coalesce_hard_cap"):
                self._coalesce_hard_cap = self.max_coalesce_rows
            self._warmed_rows = max(getattr(self, "_warmed_rows", 0), max(sizes))
            self.max_coalesce_rows = min(self._coalesce_hard_cap, self._warmed_rows)
            for q in sizes:
                if q < 2:
                    continue
                seqs = ["".join(letters[rng.integers(0, 4, size=lengths[0])])
                        for _ in range(q)]
                raw = self._count_raw(self._pad_batch(seqs))
                segs = 2
                while segs <= q:
                    seg_ids = np.minimum(np.arange(len(seqs), dtype=np.int32)
                                         * segs // len(seqs), segs - 1)
                    seg_ids = np.concatenate(
                        [seg_ids, np.full(len(raw) - len(seqs), segs - 1, np.int32)])
                    normalize_counts_segmented(
                        raw, seg_ids, segs, log2_mode=self.log2,
                        mean=self._mean_t, std=self._std_t)[:1, :1].cpu()
                    segs *= 2

    def add_targets(self, seqs=None, names=None, fasta=None):
        """Append targets to the resident corpus without a restart.

        Exactly one of ``seqs`` (with optional ``names``) or ``fasta`` (headers
        become names).  The new rows are counted and standardized with the same
        norm vectors, outside the lock, then written under it: into the pad
        rows in place when they fit the current quantum (no shape changes, so
        existing scores stay bitwise), else into a new tensor padded to the
        next quantum.  Existing indices never change.  A grow past
        ``mem_budget_bytes`` is refused before anything is uploaded.

        On a mesh the scorer re-shards its host shadow with the new rows (a
        grow within the quantum keeps every shard's shape).

        Normalization is batch-local under Log2.post (the |min| shift sees the
        rows counted together), as if the new fasta had its own kmer_counts
        run.  Returns ``(new_total, rows_added)``.
        """
        if not self._has_targets:
            raise ValueError("service started without targets: "
                             "self-similarity mode has no corpus to grow")
        if (seqs is None) == (fasta is None):
            raise ValueError("add_targets takes exactly one of "
                             "seqs / fasta")
        import torch

        from seekr_tpu_torch.ops.pearson import standardize_rows

        if fasta is not None:
            counter = self._counter(fasta)
            new_std = standardize_rows(counter.get_counts_device(nan_check=True),
                                       device=self.device)
            new_names = [h[1:] for h in counter.headers]
        else:
            seqs = list(seqs)
            if not seqs:
                raise ValueError("empty target batch")
            if names is not None and len(names) != len(seqs):
                raise ValueError(f"{len(names)} names for "
                                 f"{len(seqs)} sequences")
            new_std = standardize_rows(self._count(seqs, nan_check=True),
                                       device=self.device)
            new_names = list(names) if names is not None else None
        added = int(new_std.shape[0])
        with self._lock:
            if new_names is None:
                # numbered under the lock: concurrent grows get distinct names
                new_names = [f"t{i}" for i in range(self._n_targets,
                                                    self._n_targets + added)]
            new_total = self._n_targets + added
            prospective = (self._scorer.prospective_rows(new_total)
                           if self._scorer is not None
                           else -(-new_total // self.grow_quantum) * self.grow_quantum)
            over = self._corpus_bytes_over(prospective)
            if over:
                raise ValueError(
                    f"add_targets refused: {over}.  The resident corpus "
                    f"stays at {self._n_targets} targets; raise "
                    "mem_budget_bytes / SEEKR_TPU_CORPUS_BUDGET or shard "
                    "over a larger mesh (-dp N).")
            if self._scorer is not None:
                # the scorer drops its old shards before the grown corpus
                # uploads and restores them if the upload fails
                self._scorer.grow(new_std)
            elif new_total <= self._resident_rows():
                self._targets_std[self._n_targets:new_total] = new_std
            else:
                parts = [self._targets_std[:self._n_targets], new_std]
                if prospective > new_total:
                    parts.append(new_std.new_zeros(
                        (prospective - new_total, new_std.shape[1])))
                self._targets_std = torch.cat(parts)
            self.target_names = list(self.target_names) + new_names
            self._n_targets = len(self.target_names)
        return self._n_targets, len(new_names)

    def _sim_device(self, qc):
        """[Q, T] similarity against the resident standardized targets (or
        [Q, Q] without targets), on the card."""
        from seekr_tpu_torch.ops.pearson import (pearson_against_standardized,
                                                 pearson_device)

        if not self._has_targets:
            return pearson_device(qc, qc, device=self.device)
        if self._scorer is not None:  # the column shards, put together here
            return self._scorer.sim(qc).gather(self.device)
        return pearson_against_standardized(qc, self._targets_std, device=self.device)

    def _mesh_topk(self, qc, q: int, topk: int, with_sim: bool = False):
        """Two-stage top-k over the mesh-sharded corpus, straight from the
        normalized counts: the full [Q, T] row never exists on one device.
        Runs at the next power of two >= topk (then sliced), as
        ``_topk_device``.  With ``with_sim`` the similarity comes from the same
        shard-local GEMM, as ``(sim_dev, vals, idx)``."""
        n_req = max(1, min(int(topk), self._n_targets))
        n_run = min(_next_pow2(n_req), self._n_targets)
        if with_sim:
            sim, vals, idx = self._scorer.sim_and_topk(qc, n_run)
        else:
            vals, idx = self._scorer.topk(qc, n_run)
        out = (vals[:q, :n_req].cpu().numpy(), idx[:q, :n_req].cpu().numpy())
        return (sim.gather(self.device),) + out if with_sim else out

    def _topk_device(self, sim_dev, q: int, topk: int):
        """Top-``topk`` targets of each real query row, selected on the card;
        only [q, topk] values and int32 indices cross to the host.

        The selection runs at the next power of two >= topk and is sliced, as
        in seekr_tpu.  Only the first ``limit`` columns are selectable: the
        real batch rows in self-similarity mode, the real targets otherwise.
        A quantized service always masks, so the rule does not change when a
        grow fills the pad exactly.
        """
        self_sim = not self._has_targets
        t_cols = int(sim_dev.shape[1])
        limit = q if self_sim else self._n_targets
        n_req = max(1, min(int(topk), limit))
        n_run = min(_next_pow2(n_req), t_cols)
        mask = self_sim or self.grow_quantum > 1 or limit < t_cols
        vals, idx = _topk(sim_dev, limit, n_run, mask)
        return (vals[:q, :n_req].cpu().numpy(),
                idx[:q, :n_req].int().cpu().numpy())

    def _pvals(self, sim: np.ndarray) -> np.ndarray:
        if self.fitres is None:
            raise ValueError("service started without fitres: pvals "
                             "unavailable (pass fitres= / --fitres)")
        if isinstance(self.fitres, np.ndarray):
            if self._sorted_bkg is None:
                from seekr_tpu_torch.ops.ecdf import SortedBackground

                # sorted once per process: a query pays only the searchsorted
                self._sorted_bkg = SortedBackground(self.fitres)
            return np.asarray(self._sorted_bkg.pvals(sim), dtype=sim.dtype)
        distname, _, params = self.fitres[0]
        from seekr_tpu_torch.stats.fast_cdf import fast_cdf

        cdf = fast_cdf(distname, params, sim)
        if cdf is None:
            from scipy import stats as spstats

            cdf = getattr(spstats, distname)(*params).cdf(sim)
        return (1.0 - cdf).astype(sim.dtype)

    def query(self, seqs: Sequence[str], want: Sequence[str] = ("sim",),
              topk: int = 10):
        """Score a query batch against the resident targets.

        ``want`` items (combine freely):
          sim         full [Q, T] similarity matrix
          pvals       full [Q, T] p-value matrix (needs fitres)
          topk        topk_sim/topk_idx [Q, topk]: the best ``topk`` targets
                      per query, selected on the card
          topk_pvals  p-values of the top-k values (implies topk)

        T = the target count (or Q in self-similarity mode, where top-k draws
        from the batch's real rows).  Thread-safe: one device pass at a time.
        """
        t0 = time.perf_counter()
        out = self._query(seqs, want, topk)
        # successful requests only: a rejected one never reaches the card
        with self._lat_lock:
            self._latencies.append(time.perf_counter() - t0)
        return out

    def latency_stats(self):
        """Client-observed latency of the last <=1024 successful queries
        (coalescing wait included), in milliseconds."""
        with self._lat_lock:
            snap = np.asarray(self._latencies, dtype=np.float64)
        if snap.size == 0:
            return {"count": 0}
        q50, q95, q99 = np.percentile(snap, (50, 95, 99)) * 1e3
        return {"count": int(snap.size),
                "p50_ms": round(float(q50), 3),
                "p95_ms": round(float(q95), 3),
                "p99_ms": round(float(q99), 3),
                "max_ms": round(float(snap.max() * 1e3), 3)}

    def _query(self, seqs, want, topk):
        want = set(want)
        unknown = want - {"sim", "pvals", "topk", "topk_pvals"}
        if unknown:
            raise ValueError(f"unknown want items: {sorted(unknown)} "
                             "(supported: sim, pvals, topk, topk_pvals)")
        if not seqs:
            raise ValueError("empty query batch")
        if "topk_pvals" in want:
            want.add("topk")
        if want & {"pvals", "topk_pvals"} and self.fitres is None:
            raise ValueError("service started without fitres: pvals "
                             "unavailable (pass fitres= / --fitres)")
        if not self._has_targets or not self.coalesce:
            # a self-similarity answer depends on its own batch: never merged
            with self._lock:
                out = self._serve_one(list(seqs), want, topk)
                self.queries_served += 1
                self.device_batches += 1
            return out
        # leader/follower coalescing: enqueue, then take the device lock; the
        # thread that gets it answers everything queued meanwhile in one pass
        # (no timer, no background thread), and a thread whose answer is ready
        # returns it.  An item is set done only under the device lock, so while
        # we hold the lock with our item undone, it is still queued.  The timed
        # acquire lets a thread whose answer lands while it waits return within
        # the poll interval.
        item = _PendingQuery(list(seqs), want, int(topk))
        with self._queue_lock:
            self._queue.append(item)
        while not item.done.is_set():
            if not self._lock.acquire(timeout=0.01):
                continue
            try:
                # drain FIFO batches of up to max_coalesce_rows (always >= 1
                # item) until our own request is served
                while not item.done.is_set():
                    with self._queue_lock:
                        batch, rows = [], 0
                        while self._queue and (
                                not batch or
                                rows + len(self._queue[0].seqs)
                                <= self.max_coalesce_rows):
                            nxt = self._queue.pop(0)
                            batch.append(nxt)
                            rows += len(nxt.seqs)
                    self._serve_coalesced(batch)
            finally:
                self._lock.release()
        if item.error is not None:
            raise item.error
        return item.result

    def _serve_one(self, seqs, want, topk):
        """One request through the card; the caller holds the lock."""
        q = len(seqs)
        qc = self._count(self._pad_batch(seqs))
        n = self._n_targets if self._has_targets else q
        out = {"m": q, "n": n}
        need_full = bool(want & {"sim", "pvals"})
        sim_dev = None
        if "topk" in want:
            if self._scorer is not None:
                # the mesh selects shard by shard; a request wanting both
                # products rides one shard-local GEMM
                if need_full:
                    sim_dev, vals, idx = self._mesh_topk(qc, q, topk, with_sim=True)
                else:
                    vals, idx = self._mesh_topk(qc, q, topk)
            else:
                sim_dev = self._sim_device(qc)
                vals, idx = self._topk_device(sim_dev, q, topk)
            out["topk_sim"], out["topk_idx"] = vals, idx
            if "topk_pvals" in want:
                out["topk_pvals"] = self._pvals(out["topk_sim"])
        elif need_full:
            sim_dev = self._sim_device(qc)
        if need_full:
            sim = sim_dev[:q, :n].cpu().numpy()
            if "sim" in want:
                out["sim"] = sim
            if "pvals" in want:
                out["pvals"] = self._pvals(sim)
        return out

    def _serve_coalesced(self, batch):
        """Answer every queued request with ONE device pass.

        All rows are counted together and normalized with the segmented
        Log2.post epilogue, so each request's |min| shift sees only its own
        rows: counts and shift are bitwise the serial path's.  The GEMM may
        pick another cuBLAS kernel for the merged row count, so sim can differ
        from serial at float-reassociation level.  If the merged pass fails,
        each item is replayed alone, so only the offender errors.
        """
        try:
            if len(batch) == 1:
                item = batch[0]
                try:
                    item.result = self._serve_one(item.seqs, item.want, item.topk)
                    self.queries_served += 1
                except Exception as err:  # noqa: BLE001 -- returned to its caller
                    item.error = err
                self.device_batches += 1
                return
            all_seqs, spans = [], []
            for item in batch:
                spans.append((len(all_seqs), len(item.seqs)))
                all_seqs.extend(item.seqs)
            padded = self._pad_batch(all_seqs)
            seg_ids = np.empty(len(padded), np.int32)
            for si, (start, ln) in enumerate(spans):
                seg_ids[start:start + ln] = si
            # pad rows are copies of the LAST sequence: in its owner's segment,
            # where a duplicate row cannot change the min
            seg_ids[len(all_seqs):] = len(batch) - 1

            from seekr_tpu_torch.ops.normalize import normalize_counts_segmented

            counts = normalize_counts_segmented(
                self._count_raw(padded), seg_ids, _next_pow2(len(batch)),
                log2_mode=self.log2, mean=self._mean_t, std=self._std_t)
            t_cols = self._n_targets
            topk_items = [it for it in batch if "topk" in it.want]
            need_full = any(it.want & {"sim", "pvals"} for it in batch)
            sim_dev = vals = idx = None
            if topk_items:
                # one top-k at the largest size asked for; smaller requests
                # take a prefix of the sorted row
                n_max = max(max(1, min(it.topk, t_cols)) for it in topk_items)
                if self._scorer is not None:
                    if need_full:
                        sim_dev, vals, idx = self._mesh_topk(counts, len(padded), n_max,
                                                             with_sim=True)
                    else:
                        vals, idx = self._mesh_topk(counts, len(padded), n_max)
                else:
                    sim_dev = self._sim_device(counts)
                    vals, idx = self._topk_device(sim_dev, len(padded), n_max)
            elif need_full:
                sim_dev = self._sim_device(counts)
            sim_np = sim_dev[:, :t_cols].cpu().numpy() if need_full else None
            for item, (start, ln) in zip(batch, spans):
                try:
                    out = {"m": ln, "n": t_cols}
                    if "topk" in item.want:
                        n_req = max(1, min(item.topk, t_cols))
                        out["topk_sim"] = vals[start:start + ln, :n_req]
                        out["topk_idx"] = idx[start:start + ln, :n_req]
                        if "topk_pvals" in item.want:
                            out["topk_pvals"] = self._pvals(out["topk_sim"])
                    if item.want & {"sim", "pvals"}:
                        s = sim_np[start:start + ln]
                        if "sim" in item.want:
                            out["sim"] = s
                        if "pvals" in item.want:
                            out["pvals"] = self._pvals(s)
                    item.result = out
                    self.queries_served += 1
                except Exception as err:  # noqa: BLE001 -- returned to its caller
                    item.error = err
            self.device_batches += 1
        except Exception:  # noqa: BLE001 -- the merged pass failed: replay alone
            for item in batch:
                if item.result is not None or item.error is not None:
                    continue
                try:
                    item.result = self._serve_one(item.seqs, item.want, item.topk)
                    self.queries_served += 1
                except Exception as err:  # noqa: BLE001 -- returned to its caller
                    item.error = err
                self.device_batches += 1
        finally:
            for item in batch:
                item.done.set()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            line = self.rfile.readline(_MAX_REQUEST)
            if not line:
                return
            if len(line) >= _MAX_REQUEST and not line.endswith(b"\n"):
                # readline hit the cap mid-line: drain the rest of the line,
                # answer one error, and stay in sync for the next request
                while True:
                    rest = self.rfile.readline(_MAX_REQUEST)
                    if not rest or rest.endswith(b"\n"):
                        break
                self.wfile.write(json.dumps(
                    {"ok": False,
                     "error": f"request line exceeds {_MAX_REQUEST} "
                              "bytes"}).encode() + b"\n")
                self.wfile.flush()
                continue
            try:
                req = json.loads(line)
                resp = self._dispatch(req)
            except Exception as err:  # protocol boundary: report, not die
                resp = {"ok": False,
                        "error": f"{type(err).__name__}: {err}"}
            shutdown = isinstance(resp, dict) and resp.pop("_shutdown", False)
            self.wfile.write(json.dumps(resp).encode() + b"\n")
            self.wfile.flush()
            if shutdown:
                # after the response is on the wire
                threading.Thread(target=self.server.shutdown, daemon=True).start()
                return

    def _check_artifact_path(self, path: str) -> str:
        """Enforce the server's artifact-write policy on a client path.

        Client-directed writes (``outfile``, ``save_corpus``) are opt-in: the
        server must have an allowed directory (``--allow-artifacts``), and the
        path, with symlinks and ``..`` resolved, must lie strictly inside it.
        Returns the resolved absolute path.
        """
        allow = getattr(self.server, "artifact_dir", None)
        if allow is None:
            raise PermissionError(
                "artifact writes over the socket are disabled: start "
                "the server with --allow-artifacts DIR to permit "
                "outfile/save_corpus paths under DIR")
        base = os.path.realpath(allow)
        apath = os.path.abspath(path)
        if os.path.lexists(apath):
            # the final component may itself be a planted symlink
            resolved = os.path.realpath(apath)
        else:
            resolved = os.path.join(os.path.realpath(os.path.dirname(apath)),
                                    os.path.basename(apath))
        # strictly inside: the directory itself as a prefix would write
        # sibling files outside it (prefix + "_sim.npy")
        if not resolved.startswith(base + os.sep):
            raise PermissionError(
                f"artifact path {path!r} resolves outside the allowed "
                f"directory {base!r}")
        return resolved

    def _dispatch(self, req):
        svc: SeekrService = self.server.service  # type: ignore[attr-defined]
        op = req.get("op", "query")
        if op == "ping":
            return {"ok": True, "k": svc.k, "log2": svc.log2,
                    "targets": (len(svc.target_names)
                                if svc.target_names else None),
                    "pvals_available": svc.fitres is not None,
                    "queries_served": svc.queries_served,
                    "device_batches": svc.device_batches,
                    "latency": svc.latency_stats()}
        if op == "add_targets":
            n, added = svc.add_targets(req.get("seqs"), names=req.get("names"),
                                       fasta=req.get("fasta"))
            return {"ok": True, "n": n, "added": added}
        if op == "save_corpus":
            path = req.get("path")
            if not path:
                return {"ok": False,
                        "error": "save_corpus needs 'path' (.npz)"}
            return {"ok": True,
                    "path": svc.save_corpus(self._check_artifact_path(path))}
        if op == "shutdown":
            return {"ok": True, "_shutdown": True}
        if op != "query":
            return {"ok": False, "error": f"unknown op {op!r}"}
        # a rejected outfile must not cost a device pass first
        outfile = req.get("outfile")
        prefix = self._check_artifact_path(outfile) if outfile else None
        out = svc.query(req["seqs"], want=tuple(req.get("want", ["sim"])),
                        topk=int(req.get("topk", 10)))
        resp = {"ok": True, "m": out["m"], "n": out["n"]}
        if req.get("names") and svc.target_names is not None:
            # the full name list on demand only: megabytes at GENCODE scale
            resp["target_names"] = svc.target_names
        for key in ("topk_sim", "topk_idx", "topk_pvals"):
            if key in out:
                resp[key] = np.asarray(out[key]).tolist()
        if "topk_idx" in out and svc.target_names is not None:
            resp["topk_names"] = [[svc.target_names[j] for j in row]
                                  for row in out["topk_idx"]]
        if prefix:
            # artifact mode: every final path is checked before any write, and
            # each write is temp + os.replace
            paths = {key: self._check_artifact_path(f"{prefix}_{key}.npy")
                     for key in ("sim", "pvals") if key in out}
            for key, path in paths.items():
                _atomic_npy_save(path, np.asarray(out[key]))
            resp["files"] = paths
            return resp
        for key in ("sim", "pvals"):
            if key in out:
                resp[key] = np.asarray(out[key]).tolist()
        return resp


class _Server(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


def serve_forever(service: SeekrService, socket_path: str,
                  ready_event: Optional[threading.Event] = None,
                  artifact_dir: Optional[str] = None) -> None:
    """Blocking accept loop until a ``shutdown`` request; a stale socket file
    is removed first.

    The socket is created owner-only (0600) through the umask before bind, so
    no other local user can reach it in between.  ``artifact_dir`` opts in to
    client-directed disk writes, confined to that directory.
    """
    try:
        os.unlink(socket_path)
    except FileNotFoundError:
        pass
    old_umask = os.umask(0o177)  # bind() creates the socket file 0600
    try:
        server_cm = _Server(socket_path, _Handler)
    finally:
        os.umask(old_umask)
    try:
        with server_cm as server:
            server.service = service  # type: ignore[attr-defined]
            server.artifact_dir = artifact_dir  # type: ignore[attr-defined]
            if ready_event is not None:
                ready_event.set()
            server.serve_forever()
    finally:
        service.stop_followers()
        try:
            os.unlink(socket_path)
        except FileNotFoundError:
            pass


def request(socket_path: str, payload: dict, timeout: float = 600.0) -> dict:
    """One-shot client: send a request dict, return the response dict.
    Imports no torch."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(timeout)
        sock.connect(socket_path)
        sock.sendall(json.dumps(payload).encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)
