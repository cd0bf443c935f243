"""A reader of the safetensors format, for HF checkpoints.

The port's stand-in for the ``safetensors`` package that the JAX package's
``models/loader.py`` opens checkpoints with. The card's machine has no
``safetensors``, so the format is read here by hand, as
``utils/serialization.py`` writes msgpack by hand.

File layout (all integers little-endian)::

    n       u64                          8 bytes
    header  JSON object                  n bytes
    data    raw tensor bytes             rest

Each header entry but ``__metadata__`` (a string map, skipped) is ``name →
{"dtype", "shape", "data_offsets": [begin, end]}``, with the offsets
relative to the start of ``data``. The file is mapped with ``mmap`` and a
tensor is a zero-copy ``torch.frombuffer`` view of its bytes: it costs no
memory until it is read, and the caller copies it to the device only if
its slot wants it. bf16 and fp8 come back as their raw bits (never through
f32). A view keeps the mapping alive after the file is closed.

A malformed file is refused with ``ValueError`` naming the file and, where
there is one, the tensor: a header longer than the file, an entry whose
offsets lie outside the data or overlap another's, a byte count that does
not match the shape, an unknown dtype.

:func:`write_safetensors` writes the same format (the quantized-weight
cache's files): tensors one at a time from wherever they live, to a
temporary name renamed into place, so a reader never sees half a file.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

#: safetensors dtype name → torch dtype
DTYPES: Dict[str, torch.dtype] = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F32": torch.float32,
    "F64": torch.float64,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}


class SafetensorsFile:
    """One ``.safetensors`` file, mapped copy-on-write: the views are
    writable tensors, and writing one never writes the file. Use it as a
    context manager."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self._file = open(self.path, "rb")
        try:
            self._entries, self._metadata, self._data_start = self._read_header()
            self._map: Optional[mmap.mmap] = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_COPY)
        except BaseException:
            self._file.close()
            raise

    def _fail(self, what: str, name: Optional[str] = None) -> ValueError:
        where = f"{self.path}" + (f": tensor {name!r}" if name is not None else "")
        return ValueError(f"{where}: {what}")

    def _read_header(self) -> Tuple[Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]],
                                    Optional[Dict[str, str]], int]:
        size = self.path.stat().st_size
        head = self._file.read(8)
        if len(head) < 8:
            raise self._fail(f"{size} bytes is too short for a safetensors header length")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise self._fail(f"header of {n} bytes is longer than the file ({size} bytes)")
        try:
            header = json.loads(self._file.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise self._fail(f"header is not JSON: {exc}") from None
        if not isinstance(header, dict):
            raise self._fail("header is not a JSON object")
        data_len = size - 8 - n
        metadata = header.pop("__metadata__", None)
        entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        for name, info in header.items():
            if not isinstance(info, dict):
                raise self._fail("entry is not an object", name)
            dtype = DTYPES.get(info.get("dtype"))
            if dtype is None:
                raise self._fail(f"unknown dtype {info.get('dtype')!r}", name)
            shape = info.get("shape")
            offsets = info.get("data_offsets")
            if not (isinstance(shape, list)
                    and all(isinstance(d, int) and d >= 0 for d in shape)):
                raise self._fail(f"bad shape {shape!r}", name)
            if not (isinstance(offsets, list) and len(offsets) == 2
                    and all(isinstance(o, int) for o in offsets)):
                raise self._fail(f"bad data_offsets {offsets!r}", name)
            begin, end = offsets
            if not 0 <= begin <= end <= data_len:
                raise self._fail(f"data_offsets [{begin}, {end}] lie outside the "
                                 f"{data_len} data bytes", name)
            want = math.prod(shape) * dtype.itemsize
            if end - begin != want:
                raise self._fail(f"{end - begin} bytes do not match shape {shape} of "
                                 f"{info['dtype']} ({want} bytes)", name)
            entries[name] = (dtype, tuple(shape), begin, end)
        spans = sorted((b, e, name) for name, (_, _, b, e) in entries.items() if e > b)
        for (_, e0, n0), (b1, _, n1) in zip(spans, spans[1:]):
            if b1 < e0:
                raise self._fail(f"data overlaps that of {n0!r}", n1)
        return entries, metadata, 8 + n

    def keys(self) -> List[str]:
        """The tensor names, sorted (as ``safe_open(...).keys()`` lists
        them)."""
        return sorted(self._entries)

    def metadata(self) -> Optional[Dict[str, str]]:
        return self._metadata

    def get_tensor(self, name: str) -> torch.Tensor:
        """A zero-copy CPU view of one tensor (a copy only where its bytes
        do not sit at an address aligned to its element size)."""
        if name not in self._entries:
            raise KeyError(f"{self.path}: no tensor {name!r}")
        if self._map is None:
            raise ValueError(f"{self.path} is closed")
        dtype, shape, begin, end = self._entries[name]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=end - begin,
                               offset=self._data_start + begin)
        if raw.data_ptr() % dtype.itemsize:
            raw = raw.clone()
        return raw.view(dtype).reshape(shape)

    def close(self) -> None:
        # the mapping is never closed by hand: torch.frombuffer holds a
        # reference to it, not a buffer export, so mmap.close() would unmap
        # the pages under live views. It unmaps when the last view goes.
        self._map = None
        self._file.close()

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


#: torch dtype → safetensors dtype name
DTYPE_NAMES: Dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}


def write_safetensors(path: str | Path, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (name → tensor, on any device) as one safetensors
    file: the header (padded with spaces to 8 bytes) and each tensor's raw
    bytes in name order, copied to the host one tensor at a time. Written to
    ``<path>.tmp-<pid>`` and renamed over ``path``. → bytes written."""
    path = Path(path)
    names = sorted(tensors)
    header: Dict[str, Any] = {}
    off = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in DTYPE_NAMES:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for name in names:
                t = tensors[name].detach().contiguous().reshape(-1)
                f.write(t.view(torch.uint8).cpu().numpy().data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    return 8 + len(raw) + off
