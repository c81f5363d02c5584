"""Environment health report of the port: ``python -m seekr_tpu_torch.cli doctor``.

Port of ``seekr_tpu/utils/doctor.py:117``.  The port spans PyTorch on the card,
the CUDA kernels built by ``nvcc`` at first use, the host C++ library built by
g++ at first use, and the Python stack; a broken piece usually surfaces as a
confusing error further down.  The doctor checks each and prints one line per
check:

  versions   python, torch and the CUDA it was built for, numpy, scipy
  card       the card's name and power limit (``nvidia-smi``)
  cuda-build the ``nvcc`` build of ``csrc/*.cu`` (path, seconds)
  device     ``count_kmers_smem`` launched once and held against ``count_torch``
  native     the g++ build of the host library
  env        the ``SEEKR_TPU_*`` variables the port reads, when set

The build and the launch run in a subprocess under a timeout: a wedged card
then shows as a failed check instead of a hung doctor, and the doctor's own
process holds no CUDA context.  seekr_tpu's check of its AOT executable store
has no counterpart: the port compiles no XLA executables, and its kernel
library is rebuilt from the sources whenever they change.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Tuple

OK = "ok"
WARN = "warn"
FAIL = "fail"

ROOT = Path(__file__).resolve().parents[2]
ENV_KNOBS = ("SEEKR_TPU_MATMUL_PRECISION", "SEEKR_TPU_CORPUS_BUDGET",
             "SEEKR_TPU_HOST_SORT", "SEEKR_TPU_SCRATCH", "SEEKR_TPU_LOG",
             "SEEKR_TPU_TRACE")

# Builds the kernels and launches count_kmers_smem once on a [64, 1,024] batch
# at k=6; prints one JSON line.
_PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
import numpy as np
import torch
from seekr_tpu_torch.ops import count_cuda
from seekr_tpu_torch.ops.count import count_torch
from seekr_tpu_torch.utils import build

dev = torch.device({device!r})
t0 = time.perf_counter()
build.load_library()
build_s = time.perf_counter() - t0
rng = np.random.default_rng(0)
b = rng.integers(0, 5, size=(64, 1024), dtype=np.int8)
n = rng.integers(0, 1025, size=64).astype(np.int32)
b[np.arange(1024)[None, :] >= n[:, None]] = 4
bt, nt = torch.as_tensor(b, device=dev), torch.as_tensor(n, device=dev)
got = count_cuda.count_kmers_cuda(bt, nt, 6)
torch.cuda.synchronize(dev)
print(json.dumps({{"name": torch.cuda.get_device_name(dev), "nvcc": build.find_nvcc(),
                  "build_s": build_s, "launches": count_cuda.launches["count_kmers_smem"],
                  "equal": bool(torch.equal(got, count_torch(bt, nt, 6)))}}))
"""


def _versions() -> List[Tuple[str, str, str]]:
    rows = [(OK, "python", sys.version.split()[0])]
    for mod in ("torch", "numpy", "scipy"):
        try:
            m = __import__(mod)
        except ImportError as err:
            rows.append((FAIL, mod, f"not importable: {err}"))
            continue
        version = getattr(m, "__version__", "?")
        if mod == "torch":
            version += f" (CUDA {m.version.cuda or 'none: a CPU build'})"
        rows.append((OK, mod, version))
    return rows


def _card(timeout: float) -> Tuple[str, str, str]:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as err:
        return (FAIL, "card", f"nvidia-smi did not answer: {err}")
    if proc.returncode != 0 or not proc.stdout.strip():
        return (FAIL, "card", f"nvidia-smi failed: {proc.stderr.strip() or proc.returncode}")
    return (OK, "card", "; ".join(proc.stdout.strip().splitlines()))


def _device_probe(timeout: float, device: str = "cuda:0") -> List[Tuple[str, str, str]]:
    """The kernel build and one launch, in a fresh process under ``timeout``."""
    code = _PROBE.format(root=str(ROOT), device=device)
    try:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return [(FAIL, "device", f"probe hung >{timeout:.0f}s (the build or the "
                                 "launch did not finish; a fresh process may recover)")]
    if proc.returncode != 0:
        err = proc.stderr.strip()
        detail = err.splitlines()[-1] if err else f"exit code {proc.returncode}"
        return [(FAIL, "device", f"probe failed: {detail}")]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    ok = res["equal"] and res["launches"] == 1
    return [(OK, "cuda-build", f"{res['nvcc']}: library ready in {res['build_s']:.2f} s "
                               "(built at first use, kept per source hash)"),
            (OK if ok else FAIL, "device",
             f"{res['name']} ({device}): count_kmers_smem "
             + ("launched, bitwise equal to count_torch" if ok
                else f"WRONG: launches={res['launches']} equal={res['equal']}"))]


def _native() -> Tuple[str, str, str]:
    from seekr_tpu_torch import native
    from seekr_tpu_torch.native.build import NativeBuildError

    try:
        path = native.library_path()
    except NativeBuildError as err:
        return (FAIL, "native", f"host library did not build or load: {err}")
    return (OK, "native", f"host C++ library (g++): {path}")


def _env_knobs() -> List[Tuple[str, str, str]]:
    rows = [(WARN, "env", f"{var}={os.environ[var]} (non-default)")
            for var in ENV_KNOBS if var in os.environ]
    return rows or [(OK, "env", "no SEEKR_TPU_* overrides set")]


def run_doctor(device_timeout: float = 90.0, skip_device: bool = False,
               device: str = "cuda:0", out=None) -> bool:
    """Print the report; returns True when no check failed.  ``skip_device``
    leaves out the card, the CUDA build and the launch (host-only checks)."""
    out = out or sys.stdout
    checks: List[Tuple[str, str, str]] = []
    checks.extend(_versions())
    if not skip_device:
        checks.append(_card(device_timeout))
        checks.extend(_device_probe(device_timeout, device))
    checks.append(_native())
    checks.extend(_env_knobs())

    healthy = True
    for status, name, detail in checks:
        print(f"[{status:4s}] {name:10s} {detail}", file=out)
        healthy &= status != FAIL
    print("doctor: " + ("all checks passed" if healthy else "FAILURES above"), file=out)
    return healthy
