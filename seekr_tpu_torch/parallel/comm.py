"""Processes of one mesh: the ``torch.distributed`` bootstrap and the collectives.

Port of the multi-process half of ``seekr_tpu/parallel/dist.py``'s bootstrap
(``init_distributed``, ``:38-51``) and of the collectives JAX provides there
(``jax.process_index``/``process_count``, ``multihost_utils``).

A run over P processes holds two process groups, both made by
``init_distributed`` and used explicitly:

  * the **control group**, always ``gloo``: small host tensors -- the pod's
    headers and payloads, vote flags, heartbeats, and the metadata of every
    exchange;
  * the **data group**: ``nccl`` when every process computes on cards that no
    other process uses, decided from the card identities (UUIDs) the processes
    exchange before any collective (``data_backend``); else ``gloo``, and then a
    CUDA tensor is staged through pinned host memory by ``all_gather_parts``
    itself.  NCCL refuses two ranks on one card ("Duplicate GPU detected"), and
    gloo's ``all_gather`` takes no CUDA tensor, so one card shared by two
    processes needs the second rule.

The rule is applied once, up front, and printed; a group that fails to form
raises.  Every reduction across processes is written by the caller as an
exchange of per-shard parts (``all_gather_parts``) followed by a sum in global
shard order, never as a backend ``all_reduce``, whose order of summation
depends on its algorithm: a run over P processes then gives the bits of one
process holding the same grid.

The groups live in this module, as ``torch.distributed``'s own default group
lives in its module: one bootstrap per process.  ``stats`` counts the calls,
bytes and host seconds of each group's collectives.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

RENDEZVOUS_TIMEOUT = timedelta(seconds=300)  # as jax.distributed's initialization
# the control group's waits are bounded by the pod's own watchdog
# (SEEKR_TPU_POD_TIMEOUT), which 0 turns off: gloo must then wait as long
CONTROL_TIMEOUT = timedelta(days=30)


class CollectiveError(RuntimeError):
    """A collective failed in the transport: a peer process died or the
    connection broke.  The processes' ordered channel is no longer trusted."""


@dataclass
class _Groups:
    count: int
    index: int
    control: object
    data: object
    data_backend: str
    data_device: torch.device  # where the data group's buffers live


_groups: Optional[_Groups] = None
stats = {"control": {"calls": 0, "bytes": 0, "s": 0.0},
         "data": {"calls": 0, "bytes": 0, "s": 0.0}}


def reset_stats() -> None:
    for row in stats.values():
        row.update(calls=0, bytes=0, s=0.0)


def process_index() -> int:
    """This process's index (``jax.process_index``): 0 before a bootstrap."""
    return 0 if _groups is None else _groups.index


def process_count() -> int:
    """Processes of the run (``jax.process_count``): 1 before a bootstrap."""
    return 1 if _groups is None else _groups.count


def backends() -> dict:
    """The backend of each group: ``{"control": "gloo", "data": ...}``, or {}
    in one process."""
    if _groups is None:
        return {}
    return {"control": "gloo", "data": _groups.data_backend}


def device_identities(device=None) -> list:
    """The identities of the devices this process computes on: ``["cpu"]`` for
    the CPU (or when no card is visible), else the UUID of every visible card."""
    if (device is not None and torch.device(device).type == "cpu") or \
            not torch.cuda.is_available():
        return ["cpu"]
    return [str(torch.cuda.get_device_properties(i).uuid)
            for i in range(torch.cuda.device_count())]


def data_backend(identities) -> str:
    """The data group's backend from each process's device identities (a list
    per process): ``nccl`` when no process computes on the CPU and no card
    appears in two processes, else ``gloo``."""
    seen = {}
    for proc, ids in enumerate(identities):
        for ident in set(ids):
            if ident == "cpu" or seen.setdefault(ident, proc) != proc:
                return "gloo"
    return "nccl"


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None) -> None:
    """Join ``num_processes`` processes (the counterpart of
    ``jax.distributed.initialize``).

    A no-op for one process.  ``coordinator`` is ``"host:port"`` of the TCP
    rendezvous, served by process 0; None reads ``MASTER_ADDR``/``MASTER_PORT``
    (``env://``).  ``process_id`` None reads ``RANK``.  ``device`` is the kind
    of device this process computes on (``"cpu"``, or None/a card for the
    visible cards), from which the data group's backend is chosen.  The
    rendezvous waits at most 300 s.  Idempotent: a second call with the same
    process count returns.
    """
    global _groups
    if num_processes is None or num_processes <= 1:
        return
    if _groups is not None:
        if _groups.count != num_processes:
            raise ValueError(f"already joined {_groups.count} processes, "
                             f"not {num_processes}")
        return
    import torch.distributed as dist

    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError("process_id is not given and RANK is not set: "
                             "each process needs its index")
        process_id = int(os.environ["RANK"])
    init = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group("gloo", init_method=init, world_size=num_processes,
                            rank=process_id, timeout=RENDEZVOUS_TIMEOUT)
    control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    identities = [None] * num_processes
    dist.all_gather_object(identities, device_identities(device), group=control)
    backend = data_backend(identities)
    if backend == "nccl":
        torch.cuda.set_device(0)
        data_device = torch.device("cuda", 0)
    else:
        data_device = torch.device("cpu")
    data = dist.new_group(backend=backend, timeout=RENDEZVOUS_TIMEOUT)
    _groups = _Groups(num_processes, process_id, control, data, backend, data_device)
    why = ("every process computes on cards of its own" if backend == "nccl" else
           "a card is shared between processes, or the CPU computes; CUDA tensors "
           "are staged through pinned host memory")
    print(f"seekr_tpu_torch: process {process_id} of {num_processes}: control group "
          f"gloo, data group {backend} ({why})", flush=True)


def _require() -> _Groups:
    if _groups is None:
        raise RuntimeError("no process group: call init_distributed first")
    return _groups


def _run(which: str, nbytes: int, fn, *args, **kwargs):
    """One collective on the ``which`` group, its failure in the transport
    raised as CollectiveError."""
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    except RuntimeError as err:  # gloo and NCCL raise RuntimeError subclasses
        raise CollectiveError(f"{which} collective {fn.__name__} failed: {err}") from err
    row = stats[which]
    row["calls"] += 1
    row["bytes"] += nbytes
    row["s"] += time.perf_counter() - t0
    return out


def gather_objects(obj) -> list:
    """Every process's picklable ``obj``, in process order (control group)."""
    import torch.distributed as dist

    groups = _require()
    out = [None] * groups.count
    _run("control", 0, dist.all_gather_object, out, obj, group=groups.control)
    return out


def broadcast_from(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Process ``src``'s host ``tensor`` written into every process's
    ``tensor`` of the same shape and type (control group); returns it."""
    import torch.distributed as dist

    groups = _require()
    _run("control", tensor.numel() * tensor.element_size(), dist.broadcast, tensor, src,
         group=groups.control)
    return tensor


def all_gather_flags(flag: bool) -> np.ndarray:
    """Every process's boolean, in process order (control group)."""
    import torch.distributed as dist

    groups = _require()
    mine = torch.tensor([int(bool(flag))], dtype=torch.int32)
    out = [torch.zeros(1, dtype=torch.int32) for _ in range(groups.count)]
    _run("control", 4, dist.all_gather, out, mine, group=groups.control)
    return torch.cat(out).numpy().astype(bool)


def _nbytes(shape, dtype: str) -> int:
    return int(np.prod(shape, dtype=np.int64)) * torch.empty(0, dtype=getattr(torch, dtype)
                                                             ).element_size()


def _buffer(nbytes: int, device: torch.device, staged: bool) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, device=device, pin_memory=staged)


def all_gather_parts(parts: dict, device) -> dict:
    """Every process's ``{key: tensor}`` merged into one dict on every process.

    Keys are picklable and distinct across processes.  This process's own
    tensors come back as they are; the others' arrive on ``device``, bitwise.
    The metadata (keys, shapes, types) goes over the control group, the bytes
    in one ``all_gather`` over the data group: on the process's card for
    NCCL, through pinned host memory for gloo where a part or ``device`` is a
    card.  Every process must call it at the same point, also with no parts.
    """
    return _merge_parts(parts, device, to_leader=False)


def gather_parts(parts: dict, device) -> dict:
    """``all_gather_parts`` received by process 0 alone (one ``gather`` over
    the data group): process 0 gets every process's parts, each other process
    sends its own and gets them back unchanged."""
    return _merge_parts(parts, device, to_leader=True)


def _merge_parts(parts: dict, device, to_leader: bool) -> dict:
    import torch.distributed as dist

    groups = _require()
    device = torch.device(device)
    keys = list(parts)
    metas = gather_objects([(key, tuple(parts[key].shape), str(parts[key].dtype)[6:])
                            for key in keys])
    sizes = [sum(_nbytes(shape, dtype) for _, shape, dtype in meta) for meta in metas]
    width = max(sizes)
    if width == 0:
        return dict(parts)
    staged = groups.data_device.type == "cpu" and (
        device.type == "cuda" or any(t.is_cuda for t in parts.values()))
    send = _buffer(width, groups.data_device, staged)
    offset = 0
    for key in keys:
        raw = parts[key].detach().contiguous().reshape(-1).view(torch.uint8)
        send[offset:offset + raw.numel()].copy_(raw)
        offset += raw.numel()
    out = dict(parts)
    if to_leader and groups.index != 0:
        _run("data", width, dist.gather, send, None, dst=0, group=groups.data)
        return out
    recv = [_buffer(width, groups.data_device, staged) for _ in range(groups.count)]
    if to_leader:
        _run("data", width * groups.count, dist.gather, send, recv, dst=0, group=groups.data)
    else:
        _run("data", width * groups.count, dist.all_gather, recv, send, group=groups.data)
    for proc, meta in enumerate(metas):
        offset = 0
        for key, shape, dtype in meta:
            n = _nbytes(shape, dtype)
            if proc != groups.index:
                chunk = recv[proc][offset:offset + n].to(device, copy=True)
                out[key] = chunk.view(getattr(torch, dtype)).reshape(shape)
            offset += n
    return out
