"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded through ``ctypes``. The build happens at first use, from
the package's own sources, into ``_build/`` beside this file; the library
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source rebuilds
and an unchanged one loads the library already built. Sources build
independently: two threads loading two kernels run their ``nvcc`` processes
at the same time. Nothing here runs at import time: the CPU tests import
every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

_HERE = pathlib.Path(__file__).resolve().parent
CSRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()                      # guards _locks
_locks: Dict[str, threading.Lock] = {}        # one per source
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) of each build made
# by this process, by kernel name
build_logs: Dict[str, str] = {}
# the same for every library loaded, also one an earlier process built (its
# log is saved beside it)
saved_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install location."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of scann_tpu_torch are built from "
        "source at first use. Set CUDA_HOME to the CUDA toolkit or put nvcc "
        "on PATH.")


def _build(name: str) -> pathlib.Path:
    src = CSRC_DIR / f"{name}.cu"
    # the shared headers count too: an edited header rebuilds its users
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        if log_path.exists():
            saved_logs[name] = log_path.read_text()
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a per-process temp path, then rename: a concurrent process
    # must never load a partly written library
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    build_logs[name] = saved_logs[name] = proc.stdout + proc.stderr
    log_path.write_text(build_logs[name])
    os.replace(tmp, lib_path)
    return lib_path


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from ``csrc/<name>.cu`` (built if needed).
    Raises if the build fails; callers set ``argtypes``/``restype``."""
    with _lock:
        name_lock = _locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _libs[name] = lib
        return lib
