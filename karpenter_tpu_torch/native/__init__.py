"""The native host ring: ``ffd.cc`` built with the system C++ compiler and
bound with ctypes.

The library is compiled at first use into the library directory
(``build_dir.PATH``, which ``solver.warmup.configure_compilation_cache``
may point elsewhere), named by the source's digest so an edited source never
loads a stale library, and written to a temporary name that ``os.replace``
moves into place, so processes building at once never load a half-written
file. A build or load failure raises: the port has no executor to hide a
missing toolchain behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from karpenter_tpu_torch import build_dir

SOURCE = Path(__file__).resolve().parent / "ffd.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _find_cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("no C++ compiler found (looked at $CXX, g++ and c++ on PATH): "
                       "the native host ring cannot be built")


def build() -> Path:
    """Compile ffd.cc into the library directory and return the
    library's path; a library of the same digest is reused."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = Path(build_dir.PATH) / f"libkt_ffd_{digest}.so"
    if lib_path.exists():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_find_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kt_ffd_pack.restype = ctypes.c_int64
    lib.kt_ffd_pack.argtypes = [
        i64p, i64p, i64p, i64p,                      # shapes, counts, totals, reserved0
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # S, T, R
        ctypes.c_int64, ctypes.c_int64,              # pods_unit, r_pods
        i64p, i64p, i64p, i64p,                      # out chosen/qty/packed/dropped
        ctypes.c_int64,                              # max_records
        i64p, ctypes.c_int64,                        # prices (nullable), cost_tiebreak
    ]
    lib.kt_ffd_pack_per_pod.restype = ctypes.c_int64
    lib.kt_ffd_pack_per_pod.argtypes = [
        i64p, i64p, i64p, i64p,                      # shapes, counts, totals, reserved0
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # S, T, R
        ctypes.c_int64, ctypes.c_int64,              # pods_unit, r_pods
        i64p, i64p, i64p, i64p, i64p,                # chosen/offsets/pair_shape/pair_count/dropped
        ctypes.c_int64, ctypes.c_int64,              # max_records, max_pairs
    ]
    return lib


def load() -> ctypes.CDLL:
    """The compiled ring, built on first use; raises when it cannot be built
    or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib
