"""Tensor wire framing: the ``TPUT`` frame of the JAX package's
``distributed_gpu_inference_tpu/utils/serialization.py`` ``TensorSerializer``.

The port's own copy of ``serialize`` / ``deserialize`` only, for the spill
tier's remote entries (``runtime/kv_cache.py`` ``_pack_spill``): a remote
store shared by JAX and PyTorch workers holds frames either package reads.

Binary layout (little-endian)::

    magic   b"TPUT"                      4 bytes
    version u8                           1 byte
    flags   u8 (bit0: zstd)              1 byte
    hdr_len u32                          4 bytes
    header  msgpack {dtype, shape}       hdr_len bytes
    payload raw or zstd bytes            rest

The card's machine has no ``msgpack``, ``ml_dtypes`` or ``zstandard``, so:

- the two-key header map is encoded and decoded here by hand (a fixmap of
  two str keys, a str and an array of unsigned ints), byte-identical to
  ``msgpack.packb(..., use_bin_type=True)`` of the same dict;
- ``bfloat16`` and ``float8_e4m3fn`` payloads are the raw bits of the torch
  tensor (numpy has neither dtype without ``ml_dtypes``);
- frames are written uncompressed (flag 0), which the JAX reader accepts.
  A zstd frame is read when ``zstandard`` imports; without it
  :class:`CodecUnavailable` says so and the caller counts a miss.

Tensors come back on the CPU, in the frame's dtype and shape.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_MAGIC = b"TPUT"
_VERSION = 1
_FLAG_ZSTD = 1

# wire dtype name <-> torch dtype (the names numpy / ml_dtypes give)
_TORCH_BY_NAME: Dict[str, torch.dtype] = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int32": torch.int32,
    "int64": torch.int64,
}
_NAME_BY_TORCH = {v: k for k, v in _TORCH_BY_NAME.items()}


class CodecUnavailable(RuntimeError):
    """A frame needs a codec this process cannot import (a zstd payload
    without ``zstandard``)."""


def wire_dtype_name(dtype: torch.dtype) -> str:
    if dtype not in _NAME_BY_TORCH:
        raise TypeError(f"no TPUT wire name for {dtype}")
    return _NAME_BY_TORCH[dtype]


def dtype_from_name(name: str) -> torch.dtype:
    if name not in _TORCH_BY_NAME:
        raise ValueError(f"unsupported TPUT dtype {name!r}")
    return _TORCH_BY_NAME[name]


# ---------------------------------------------------------------- msgpack

def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        return bytes([0xA0 | n]) + b
    if n < 256:
        return b"\xd9" + bytes([n]) + b
    return b"\xda" + struct.pack(">H", n) + b


def _pack_uint(v: int) -> bytes:
    if v < 0:
        raise ValueError(f"negative shape entry {v}")
    if v < 128:
        return bytes([v])
    if v < 1 << 8:
        return b"\xcc" + bytes([v])
    if v < 1 << 16:
        return b"\xcd" + struct.pack(">H", v)
    if v < 1 << 32:
        return b"\xce" + struct.pack(">I", v)
    return b"\xcf" + struct.pack(">Q", v)


def pack_header(dtype_name: str, shape: Tuple[int, ...]) -> bytes:
    """``msgpack.packb({"dtype": name, "shape": list(shape)},
    use_bin_type=True)``, byte for byte."""
    n = len(shape)
    arr = bytes([0x90 | n]) if n < 16 else b"\xdc" + struct.pack(">H", n)
    return (b"\x82" + _pack_str("dtype") + _pack_str(dtype_name)
            + _pack_str("shape") + arr + b"".join(_pack_uint(int(d)) for d in shape))


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data, self.i = data, 0

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.data):
            raise ValueError("truncated TPUT header")
        out = self.data[self.i:self.i + n]
        self.i += n
        return out

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0x80 <= t <= 0x8F:
            return {self.obj(): self.obj() for _ in range(t & 0x0F)}
        if t == 0xD9:
            return self.take(self.take(1)[0]).decode("utf-8")
        if t == 0xDA:
            return self.take(struct.unpack(">H", self.take(2))[0]).decode("utf-8")
        if t == 0xDC:
            return [self.obj() for _ in range(struct.unpack(">H", self.take(2))[0])]
        fmt = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}.get(t)
        if fmt is None:
            raise ValueError(f"unexpected msgpack type byte {t:#04x} in a TPUT header")
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def unpack_header(data: bytes) -> Tuple[str, List[int]]:
    hdr = _Reader(data).obj()
    if not isinstance(hdr, dict) or not isinstance(hdr.get("dtype"), str) \
            or not isinstance(hdr.get("shape"), list):
        raise ValueError(f"malformed TPUT header {hdr!r}")
    return hdr["dtype"], [int(d) for d in hdr["shape"]]


# ---------------------------------------------------------------- frames

def serialize(tensor: torch.Tensor) -> bytes:
    """One tensor → an uncompressed ``TPUT`` frame of its raw bytes."""
    t = tensor.detach().to("cpu").contiguous()
    name = wire_dtype_name(t.dtype)
    payload = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
    header = pack_header(name, tuple(t.shape))
    return b"".join([_MAGIC, struct.pack("<BB", _VERSION, 0),
                     struct.pack("<I", len(header)), header, payload])


def _check_prefix(data: bytes) -> int:
    if len(data) < 10 or data[:4] != _MAGIC:
        raise ValueError("bad magic: not a TPUT tensor frame")
    version, flags = struct.unpack_from("<BB", data, 4)
    if version != _VERSION:
        raise ValueError(f"unsupported frame version {version}")
    return flags


def deserialize(data: bytes) -> torch.Tensor:
    """A ``TPUT`` frame → a CPU tensor of its dtype and shape. Raises
    :class:`CodecUnavailable` for a zstd frame without ``zstandard`` and
    ``ValueError`` for a malformed one."""
    flags = _check_prefix(data)
    (hdr_len,) = struct.unpack_from("<I", data, 6)
    name, shape = unpack_header(data[10:10 + hdr_len])
    payload = data[10 + hdr_len:]
    if flags & _FLAG_ZSTD:
        try:
            import zstandard
        except ImportError:
            raise CodecUnavailable(
                "zstd-compressed TPUT frame and no zstandard module") from None
        payload = zstandard.ZstdDecompressor().decompress(payload)
    dtype = dtype_from_name(name)
    count = int(np.prod(shape)) if shape else 1
    if len(payload) != count * dtype.itemsize:
        raise ValueError(f"TPUT payload of {len(payload)} bytes for {name} {shape}")
    raw = torch.frombuffer(bytearray(payload), dtype=torch.uint8) if payload \
        else torch.empty(0, dtype=torch.uint8)
    return raw.view(dtype).reshape(shape)
