"""Host-side C++ components of the port, built at first use and loaded over
ctypes.

The port of ``distributed_gpu_inference_tpu/native/``, with its own copy
of the source (``src/radix_index.cpp``) and the same C ABI. The library is
built with the system C++ compiler (``$CXX``, default ``g++``) the first
time an engine asks for it, into ``build/native/`` at the root of the
checkout (a directory ``.gitignore`` lists), under a name that carries a
hash of the source and flags: an edited source is rebuilt, an unchanged
one reused. The build writes a temporary file and renames it into place,
so a worker and its rank processes, building at once, never load a
half-written library.

Components:

- ``radix_index.cpp``: the prefix-cache radix tree the KV block manager
  probes for every admitted prompt (``runtime/kv_cache.py``
  ``make_radix_index``). Its exact-semantics Python fallback is
  ``runtime.kv_cache.RadixPrefixIndex``, taken with a logged warning when
  no compiler exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger("torch_native")

SRC = Path(__file__).resolve().parent / "src" / "radix_index.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_load_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libradix_index-{digest[:16]}.so"


def _compile(src: Path, out: Path) -> bool:
    tmp = None
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        # build to a temporary name, then rename: a concurrent loader never
        # opens a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(out.parent))
        os.close(fd)
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            log.warning("native build failed:\n%s", proc.stderr[-2000:])
            return False
        os.replace(tmp, out)
        tmp = None
        return True
    except (OSError, subprocess.TimeoutExpired) as exc:
        # no compiler, a read-only checkout: the Python fallback
        log.warning("native build unavailable: %s", exc)
        return False
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    with _load_lock:
        if _lib_tried:
            return _lib
        try:
            lib = _load_locked()
        except Exception as exc:  # noqa: BLE001 — e.g. a library missing a symbol
            log.warning("native load failed (cached as unavailable): %s", exc)
            lib = None
        _lib = lib
        _lib_tried = True   # success or failure: the probe runs once
        return _lib


def _load_locked() -> Optional[ctypes.CDLL]:
    out = library_path()
    if not out.exists() and not _compile(SRC, out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as exc:
        log.warning("could not load the native library: %s", exc)
        return None
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.radix_new.argtypes = [ctypes.c_int]
    lib.radix_new.restype = ctypes.c_void_p
    lib.radix_destroy.argtypes = [ctypes.c_void_p]
    lib.radix_destroy.restype = None
    for name in ("radix_match", "radix_insert"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64, i64p, ctypes.c_int64]
        fn.restype = ctypes.c_int64
    for name in ("radix_contains", "radix_is_leaf", "radix_remove"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        fn.restype = ctypes.c_int
    lib.radix_size.argtypes = [ctypes.c_void_p]
    lib.radix_size.restype = ctypes.c_int64
    return lib


def native_available() -> bool:
    """Whether the library builds and loads (never raises)."""
    try:
        return _load() is not None
    except Exception as exc:  # noqa: BLE001 — the contract is a boolean
        log.warning("native probe failed: %s", exc)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    return _load()
