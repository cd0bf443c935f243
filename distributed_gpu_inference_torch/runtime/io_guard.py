"""Crash-atomic file writes: temp file + fsync + rename.

The port's own copy of the atomic writers of
``distributed_gpu_inference_tpu/runtime/io_guard.py``. The worker writes
its issued credentials (``utils/config.py`` ``save_worker_config``) and its
machine fingerprint through them: a crash or a full disk mid-write must
leave the previous file intact, never a truncated one.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union


def atomic_write_bytes(path: Union[str, Path], data: bytes) -> None:
    """Write ``data`` to ``path`` atomically: a sibling temp file is
    written and fsynced first, then renamed over the target (os.replace is
    atomic on POSIX within one filesystem). A failure at any point leaves
    the previous file intact; the temp is cleaned up. Raises OSError —
    callers decide whether the write was optional (fingerprint cache) or
    not (issued credentials)."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise


def atomic_write_text(path: Union[str, Path], text: str,
                      encoding: str = "utf-8") -> None:
    atomic_write_bytes(path, text.encode(encoding))
