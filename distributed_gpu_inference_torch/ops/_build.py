"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes). Libraries land in ``build/kernels/`` at
the root of the checkout — a directory ``.gitignore`` lists — under a name
that carries a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is reused. A source may also be built as a
variant with preprocessor defines (``defines=(("QMM_STAGES", 3),)``): its
own library, for measurements that compare a kernel's compile-time
choices. Nothing here runs at import time: the CPU tests import every
module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("ragged_paged_attention", "paged_decode_fused", "qmm_w8a16")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

Defines = Tuple[Tuple[str, int], ...]

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Defines], ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels build from "
        "distributed_gpu_inference_torch/csrc at first use"
    )


def _flags(defines: Defines) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{k}={v}" for k, v in defines)


def _digest(name: str, defines: Defines) -> str:
    h = hashlib.sha256()
    h.update(" ".join(_flags(defines)).encode())
    for p in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _tag(defines: Defines) -> str:
    return "".join(f"-{k}{v}" for k, v in defines)


def library_path(name: str, defines: Defines = ()) -> Path:
    return BUILD_DIR / f"lib{name}{_tag(defines)}-{_digest(name, defines)}.so"


def build_log_path(name: str, defines: Defines = ()) -> Path:
    return BUILD_DIR / f"{name}{_tag(defines)}.log"


def _start(name: str, defines: Defines, nvcc: str) -> subprocess.Popen:
    out = library_path(name, defines)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc, *_flags(defines), "-I", str(CSRC_DIR), "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names: Iterable = KERNEL_SOURCES) -> float:
    """Compile every listed kernel that has no up-to-date library yet, one
    ``nvcc`` per source, all started together. An entry is a source name
    or a ``(name, defines)`` variant. Returns the wall seconds. Raises with
    the compiler's output when a build fails."""
    t0 = time.perf_counter()
    todo = [(n, ()) if isinstance(n, str) else (n[0], tuple(n[1])) for n in names]
    todo = [t for t in dict.fromkeys(todo) if not library_path(*t).is_file()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {t: _start(*t, nvcc) for t in todo}
    failed = []
    for (name, defines), proc in procs.items():
        log, _ = proc.communicate()
        build_log_path(name, defines).write_text(log)
        out = library_path(name, defines)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {name}{_tag(defines)} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str, defines: Defines = ()) -> ctypes.CDLL:
    """The loaded library of one kernel (or of its variant with
    ``defines``), building it first if needed."""
    key = (name, tuple(defines))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            build([key])
            lib = ctypes.CDLL(str(library_path(*key)))
            _loaded[key] = lib
        return lib
