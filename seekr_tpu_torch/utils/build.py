"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The kernels live in ``seekr_tpu_torch/csrc/*.cu`` and expose a plain C interface
(no PyTorch headers), so a build takes seconds.  ``load_library()`` builds at first
use, from the sources in the package only, into ``seekr_tpu_torch/_build/``: one
``nvcc -c`` per source, all started together, then one link into
``libseekr_tpu_torch_kernels.<hash>.so``.  The hash covers the sources, the flags
and the compiler, so an edited source rebuilds and an unchanged one loads the
existing library.

There is no fallback: a missing ``nvcc`` or a failed compile raises
``KernelBuildError`` with the compiler's output.  The flags carry no
``--use_fast_math`` -- the count kernel's scale is an exact IEEE divide.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libseekr_tpu_torch_kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# (bases, lengths, out, m, lpad, k, scaled) of the count kernels' C functions
_COUNT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
_DEVICE_STREAM = [ctypes.c_int, ctypes.c_void_p]
# (base, m, n, c0, width) of one column block of the epilogue kernels' [m, n] buffer
_BLOCK_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]

# (name, argtypes, restype) of every exported C function
_SIGNATURES = [
    ("seekr_cuda_error_string", [ctypes.c_int], ctypes.c_char_p),
    ("seekr_count_kmers_smem", [*_COUNT_ARGS, *_DEVICE_STREAM], ctypes.c_int),
    # + log2 of count_cuda.hiblock_plan's slice_bins
    ("seekr_count_kmers_hiblocked", [*_COUNT_ARGS, ctypes.c_int, *_DEVICE_STREAM],
     ctypes.c_int),
    ("seekr_epilogue_scratch_bytes", [ctypes.c_int64, ctypes.c_int], ctypes.c_int64),
    ("seekr_epilogue_counters", [ctypes.c_int], ctypes.c_int),
    # + pre, mean_mode, std_mode, need_min; mean_in, std_in, mean_out, std_out,
    # scratch, counters, running; block
    ("seekr_epilogue_column_stats",
     [*_BLOCK_ARGS, *[ctypes.c_int] * 4, *[ctypes.c_void_p] * 7, ctypes.c_int,
      *_DEVICE_STREAM], ctypes.c_int),
    # + pre, post; mean, std, shift
    ("seekr_epilogue_normalize",
     [*_BLOCK_ARGS, ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 3, *_DEVICE_STREAM],
     ctypes.c_int),
    # + first; row_s, row_q
    ("seekr_epilogue_row_stats",
     [*_BLOCK_ARGS, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, *_DEVICE_STREAM],
     ctypes.c_int),
    # + row_s, row_q, hi, lo
    ("seekr_epilogue_standardize_split",
     [*_BLOCK_ARGS, *[ctypes.c_void_p] * 4, *_DEVICE_STREAM], ctypes.c_int),
]


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused a kernel source."""


class _Loaded:
    """The process's one loaded kernel library and the log of its build."""

    lock = threading.Lock()
    lib: ctypes.CDLL | None = None
    log: str = ""


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.environ.get("NVCC"), shutil.which("nvcc"),
                  os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
                  "/usr/local/cuda/bin/nvcc"]  # the CUDA toolkit's default prefix
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked at $NVCC, PATH, $CUDA_HOME/bin and the CUDA "
        "toolkit's default prefix); the CUDA kernels cannot be built")


def kernel_sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join([nvcc, *NVCC_FLAGS]).encode())
    for path in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with their output if one fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outputs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(cmd)
    log = "\n".join(outputs)
    if failed:
        raise KernelBuildError(f"nvcc failed ({len(failed)} command(s)):\n{log}")
    return log


def build_library() -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` into the hashed shared library, unless it exists.

    Returns (library path, compiler log); the log is empty when nothing was built.
    """
    nvcc = find_nvcc()
    lib_path = BUILD_DIR / f"{LIB_NAME}.{_source_hash(nvcc)}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, compiles = [], []
        for src in kernel_sources():
            obj = Path(tmp) / f"{src.stem}.o"
            objects.append(str(obj))
            compiles.append([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])
        log = _run_all(compiles)
        tmp_lib = Path(tmp) / lib_path.name
        log += "\n" + _run_all([[nvcc, *ARCH_FLAGS, "-shared", *objects,
                                 "-o", str(tmp_lib)]])
        os.replace(tmp_lib, lib_path)  # atomic: a process building at the same time loads either copy
    return lib_path, log


def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once per process."""
    with _Loaded.lock:
        if _Loaded.lib is None:
            path, log = build_library()
            lib = ctypes.CDLL(str(path))
            for name, argtypes, restype in _SIGNATURES:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _Loaded.lib, _Loaded.log = lib, log
        return _Loaded.lib


def build_log() -> str:
    """nvcc's output (ptxas register/spill lines included) of this process's build."""
    return _Loaded.log


def cuda_error_string(err: int) -> str:
    return load_library().seekr_cuda_error_string(int(err)).decode()
