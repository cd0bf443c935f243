"""Host-side C++ components of the port, built at first use and loaded over
ctypes.

The port of ``distributed_gpu_inference_tpu/native/``, with its own copy
of the radix source (``src/radix_index.cpp``) and the same C ABI. Each
source under ``src/`` is built into a library of its own with the system
C++ compiler (``$CXX``, default ``g++``) the first time a caller asks for
it, into ``build/native/`` at the root of the checkout (a directory
``.gitignore`` lists), under a name that carries a hash of the source and
flags: an edited source is rebuilt, an unchanged one reused. The build
writes a temporary file and renames it into place, so a worker and its
rank processes, building at once, never load a half-written library. A
source that fails to build takes only its own functions to their plain
versions.

Components:

- ``radix_index.cpp``: the prefix-cache radix tree the KV block manager
  probes for every admitted prompt (``runtime/kv_cache.py``
  ``make_radix_index``). Its exact-semantics Python fallback is
  ``runtime.kv_cache.RadixPrefixIndex``, taken with a logged warning when
  no compiler exists.
- ``image_codec.cpp``: the vision engine's host image path, the JPEG
  decoder (``utils/jpeg.py``), Pillow's bicubic resize
  (``utils/resize.py``) and the PNG row unfilter (``utils/png.py``). Each
  has a plain numpy version, taken through :func:`host_lib` with a logged
  warning that names it and counted in :data:`PLAIN_TAKEN`.
- ``zstd_codec.cpp``: the zstd decoder and encoder of the TPUT tensor wire
  (``utils/zstd.py``). The decoder's plain version is in Python; the
  encoder's is an uncompressed frame. Both are taken through
  :func:`host_lib` as the image codec's are.
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
from typing import Dict, Optional

log = logging.getLogger("torch_native")

SRC = Path(__file__).resolve().parent / "src" / "radix_index.cpp"
IMAGE_SRC = SRC.parent / "image_codec.cpp"
ZSTD_SRC = SRC.parent / "zstd_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

# the libraries probed so far, by source (None where its build or load
# failed); with _lib_tried False none was, whatever _lib holds
_lib: Optional[Dict[Path, Optional[ctypes.CDLL]]] = None
_lib_tried = False
_load_lock = threading.Lock()

# host function -> how many times its plain version ran for want of the library
PLAIN_TAKEN: Dict[str, int] = {}


def library_path(src: Path = SRC) -> Path:
    """Where the library of ``src`` and the current flags lives."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


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
            log.warning("native build of %s failed:\n%s", src.name, proc.stderr[-2000:])
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


def _load(src: Path = SRC) -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    libs = _lib
    if _lib_tried and libs is not None and src in libs:
        return libs[src]
    with _load_lock:
        if not _lib_tried or _lib is None:
            _lib, _lib_tried = {}, True
        if src not in _lib:
            try:
                lib = _load_locked(src)
            except Exception as exc:  # noqa: BLE001 — e.g. a library missing a symbol
                log.warning("native load of %s failed (cached as unavailable): %s",
                            src.name, exc)
                lib = None
            _lib[src] = lib   # success or failure: each source is probed once
        return _lib[src]


def _bind_radix(lib: ctypes.CDLL) -> None:
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


def _bind_image_codec(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p, err = ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p
    lib.jpeg_info.argtypes = [u8p, ctypes.c_int64, i32p, i32p, i32p, err, ctypes.c_int]
    lib.jpeg_decode_rgb.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64, err, ctypes.c_int]
    lib.resize_bicubic_rgb.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, u8p,
                                       ctypes.c_int32, ctypes.c_int32]
    lib.png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, u8p]
    for fn in (lib.jpeg_info, lib.jpeg_decode_rgb, lib.resize_bicubic_rgb, lib.png_unfilter):
        fn.restype = ctypes.c_int


def _bind_zstd(lib: ctypes.CDLL) -> None:
    u8p, err, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, ctypes.c_int64
    lib.zstd_decompress.argtypes = [u8p, i64, u8p, i64, err, ctypes.c_int]
    lib.zstd_compress.argtypes = [u8p, i64, u8p, i64, err, ctypes.c_int]
    lib.zstd_compress_bound.argtypes = [i64]
    for fn in (lib.zstd_decompress, lib.zstd_compress, lib.zstd_compress_bound):
        fn.restype = i64


_BIND = {SRC.stem: _bind_radix, IMAGE_SRC.stem: _bind_image_codec, ZSTD_SRC.stem: _bind_zstd}


def _load_locked(src: Path) -> Optional[ctypes.CDLL]:
    out = library_path(src)
    if not out.exists() and not _compile(src, out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as exc:
        log.warning("could not load the native library %s: %s", out.name, exc)
        return None
    _BIND[src.stem](lib)
    return lib


def native_available(src: Path = SRC) -> bool:
    """Whether the library of ``src`` builds and loads (never raises)."""
    try:
        return _load(src) is not None
    except Exception as exc:  # noqa: BLE001 — the contract is a boolean
        log.warning("native probe failed: %s", exc)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The radix index's library, or None."""
    return _load(SRC)


def host_lib(function: str, plain: str, src: Path = IMAGE_SRC) -> Optional[ctypes.CDLL]:
    """The library of ``src`` (by default the image codec's) for the host
    function ``function``, or None, and then ``plain`` (its plain version)
    runs: counted in :data:`PLAIN_TAKEN`, and said in a warning the first
    time."""
    lib = _load(src)
    if lib is not None:
        return lib
    PLAIN_TAKEN[function] = PLAIN_TAKEN.get(function, 0) + 1
    if PLAIN_TAKEN[function] == 1:
        log.warning("native %s unavailable, using its plain version %s", function, plain)
    return None
