"""Build the port's host C++ library with g++ at first use.

Port of ``seekr_tpu/native/build.py``: the sources in ``native/src/`` are
compiled with ``g++ -O3 -std=c++17 -fPIC -shared -pthread`` (no ``-march``, so a
built library stays valid on another host) into
``seekr_tpu_torch/_build/libseekr_tpu_torch_native.<hash>.so``.  The hash covers
the compiler, the flags and every source and header, so an edited source rebuilds
and an unchanged one loads the library already there.

Each source is compiled by its own ``g++ -c``, all started together, then linked
once.  Processes that build at the same time (the workers of a parallel test
run) take an ``fcntl`` lock on ``_build/native.lock``, so one of them compiles
and the others load its library; the library is written to a per-process
temporary name and published with an atomic rename.

There is no fallback: a missing g++ or a failed compile raises
``NativeBuildError`` with the compiler's output.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libseekr_tpu_torch_native"
SOURCES = ("leiden.cpp", "fastio.cpp", "csvio.cpp", "sortops.cpp", "statops.cpp")
HEADERS = ("host_parallel.h",)  # hashed, not passed to g++
CXX = "g++"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    """g++ is missing, or it refused a source."""


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join([CXX, *FLAGS]).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with their output if one fails."""
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
    except OSError as e:
        raise NativeBuildError(f"failed to run {cmds[0][0]}: {e}") from e
    outputs, failed = [], 0
    for cmd, proc in zip(cmds, procs):
        try:
            out, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += "\n(timed out after 300 s)"
        outputs.append(f"$ {' '.join(cmd)}\n{out}")
        failed += proc.returncode != 0
    log = "\n".join(outputs)
    if failed:
        raise NativeBuildError(f"{cmds[0][0]} failed ({failed} command(s)):\n{log}")
    return log


def build_native_lib() -> str:
    """Compile the library unless it exists; return its path."""
    with _LOCK:
        lib_path = BUILD_DIR / f"{LIB_NAME}.{_source_hash()}.so"
        if lib_path.exists():
            return str(lib_path)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "native.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if lib_path.exists():  # another process built it while we waited
                return str(lib_path)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                objects = [os.path.join(tmp, f"{Path(s).stem}.o") for s in SOURCES]
                _run_all([[CXX, *FLAGS, "-c", str(SRC_DIR / s), "-o", obj]
                          for s, obj in zip(SOURCES, objects)])
                tmp_lib = os.path.join(tmp, f"{lib_path.name}.{os.getpid()}")
                _run_all([[CXX, *FLAGS, "-o", tmp_lib, *objects]])
                os.replace(tmp_lib, lib_path)
        return str(lib_path)
