"""The mutator's C++ host core (``scann_host.cpp`` beside this file),
loaded with ctypes (counterpart of ``scann_tpu/native/__init__.py``).

``load_native()`` builds the library with ``g++`` at first use, from the
port's own copy of the source, into ``_build/`` beside ``native.py``'s CUDA
libraries, under a name that carries a hash of the source and the flags.
It returns the configured library, or None when it cannot be built or
loaded: the mutator then takes its pure-Python core, which has the same
semantics. This is host code by nature, not a fallback for a missing card.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

from scann_tpu_torch.native import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parent / "scann_host.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> pathlib.Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libscann_host-{digest}.so"


def _build(path: pathlib.Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a per-process temporary file, then rename: concurrent
    # processes (pytest-xdist workers) must never load a half-written one
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load_native() -> Optional[ctypes.CDLL]:
    """The host core's ctypes library, built if needed; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        _declare(lib)
        _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    vp = ctypes.c_void_p

    lib.mds_create.restype = vp
    lib.mds_create.argtypes = [u64, u64]
    lib.mds_destroy.restype = None
    lib.mds_destroy.argtypes = [vp]
    lib.mds_add.restype = i64
    lib.mds_add.argtypes = [vp, fp]
    lib.mds_add_many.restype = i64
    lib.mds_add_many.argtypes = [vp, fp, u64]
    lib.mds_remove.restype = ctypes.c_int
    lib.mds_remove.argtypes = [vp, u64]
    lib.mds_update.restype = ctypes.c_int
    lib.mds_update.argtypes = [vp, u64, fp]
    lib.mds_get.restype = ctypes.c_int
    lib.mds_get.argtypes = [vp, u64, fp]
    lib.mds_exists.restype = ctypes.c_int
    lib.mds_exists.argtypes = [vp, u64]
    lib.mds_size.restype = u64
    lib.mds_size.argtypes = [vp]
    lib.mds_rows.restype = u64
    lib.mds_rows.argtypes = [vp]
    lib.mds_snapshot.restype = u64
    lib.mds_snapshot.argtypes = [vp, fp, u8p, u64]
    lib.mds_compact.restype = u64
    lib.mds_compact.argtypes = [vp]

    lib.mbuf_create.restype = vp
    lib.mbuf_create.argtypes = [u64]
    lib.mbuf_destroy.restype = None
    lib.mbuf_destroy.argtypes = [vp]
    lib.mbuf_push.restype = ctypes.c_int
    lib.mbuf_push.argtypes = [vp, i32, u64, fp, u64]
    lib.mbuf_len.restype = u64
    lib.mbuf_len.argtypes = [vp]
    lib.mbuf_pop.restype = ctypes.c_int
    lib.mbuf_pop.argtypes = [vp, ctypes.POINTER(i32), ctypes.POINTER(u64),
                             ctypes.POINTER(u64), fp, u64]
