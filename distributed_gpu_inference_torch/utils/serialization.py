"""Tensor wire framing: the ``TPUT`` frame of the JAX package's
``distributed_gpu_inference_tpu/utils/serialization.py`` ``TensorSerializer``.

The port's own copy of ``serialize`` / ``deserialize`` and of the msgpack
header codec, for the spill tier's remote entries (``runtime/kv_cache.py``
``_pack_spill``) and the KV handoff's wire (``runtime/kv_handoff.py``): a
remote store or a data plane shared by JAX and PyTorch workers carries
frames either package reads.

Binary layout (little-endian)::

    magic   b"TPUT"                      4 bytes
    version u8                           1 byte
    flags   u8 (bit0: zstd)              1 byte
    hdr_len u32                          4 bytes
    header  msgpack {dtype, shape}       hdr_len bytes
    payload raw or zstd bytes            rest

The card's machine has no ``msgpack``, ``ml_dtypes`` or ``zstandard``, so:

- msgpack is encoded and decoded here by hand (:func:`packb` /
  :func:`unpackb`, byte-identical to ``msgpack.packb(obj,
  use_bin_type=True)`` / ``msgpack.unpackb(raw=False)`` for None, bool,
  int, float, str, bytes, lists and maps): the frame's two-key header here,
  and the KV handoff's metadata and stream frames in
  ``runtime/kv_handoff.py``;
- ``bfloat16`` and ``float8_e4m3fn`` payloads are the raw bits of the torch
  tensor (numpy has neither dtype without ``ml_dtypes``);
- zstd payloads go through the port's own codec (``utils/zstd.py``).
  :func:`serialize` follows the JAX ``TensorSerializer``'s rule: with
  ``compress=True`` a payload of ``min_compress_bytes`` (4,096) or more is
  compressed as libzstd's level 3 would be (the JAX default, and the only
  level it writes) and the frame keeps the smaller of the two
  (flag 1 where it is the zstd frame). Uncompressed frames equal the JAX
  package's ``compress=False`` frames byte for byte; compressed ones are
  not libzstd's bytes but decode to the same payload in either package.
  :func:`deserialize` reads either, and raises :class:`CodecUnavailable`
  only for a zstd frame made with a dictionary, which no writer makes.

Tensors come back on the CPU, in the frame's dtype and shape.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import zstd
from .zstd import CodecUnavailable  # noqa: F401 — callers catch serialization.CodecUnavailable

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


def wire_dtype_name(dtype: torch.dtype) -> str:
    if dtype not in _NAME_BY_TORCH:
        raise TypeError(f"no TPUT wire name for {dtype}")
    return _NAME_BY_TORCH[dtype]


def dtype_from_name(name: str) -> torch.dtype:
    if name not in _TORCH_BY_NAME:
        raise ValueError(f"unsupported TPUT dtype {name!r}")
    return _TORCH_BY_NAME[name]


# ---------------------------------------------------------------- msgpack

def _pack_into(out: List[bytes], obj: Any) -> None:
    """Append the msgpack encoding of ``obj`` — the choices
    ``msgpack.packb(obj, use_bin_type=True)`` makes: the smallest int
    encoding (fixints, then 8/16/32/64-bit, unsigned for positive values),
    floats as float64, str as fixstr / str8 / str16 / str32, bytes as bin,
    lists and tuples as arrays, dicts as maps in insertion order."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        v = int(obj)
        if 0 <= v < 128:
            out.append(bytes([v]))
        elif v > 0:
            if v < 1 << 8:
                out.append(b"\xcc" + bytes([v]))
            elif v < 1 << 16:
                out.append(b"\xcd" + struct.pack(">H", v))
            elif v < 1 << 32:
                out.append(b"\xce" + struct.pack(">I", v))
            elif v < 1 << 64:
                out.append(b"\xcf" + struct.pack(">Q", v))
            else:
                raise OverflowError(f"int {v} does not fit msgpack")
        elif v >= -32:
            out.append(struct.pack(">b", v))
        elif v >= -(1 << 7):
            out.append(b"\xd0" + struct.pack(">b", v))
        elif v >= -(1 << 15):
            out.append(b"\xd1" + struct.pack(">h", v))
        elif v >= -(1 << 31):
            out.append(b"\xd2" + struct.pack(">i", v))
        elif v >= -(1 << 63):
            out.append(b"\xd3" + struct.pack(">q", v))
        else:
            raise OverflowError(f"int {v} does not fit msgpack")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.append(b"\xd9" + bytes([n]))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        n = len(b)
        if n < 1 << 8:
            out.append(b"\xc4" + bytes([n]))
        elif n < 1 << 16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x90 | n]))
        elif n < 1 << 16:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for x in obj:
            _pack_into(out, x)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x80 | n]))
        elif n < 1 << 16:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for k, x in obj.items():
            _pack_into(out, k)
            _pack_into(out, x)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, byte for byte, for None,
    bool, int, float, str, bytes, lists/tuples and dicts of these."""
    out: List[bytes] = []
    _pack_into(out, obj)
    return b"".join(out)


def pack_header(dtype_name: str, shape: Tuple[int, ...]) -> bytes:
    """``msgpack.packb({"dtype": name, "shape": list(shape)},
    use_bin_type=True)``, byte for byte."""
    if any(int(d) < 0 for d in shape):
        raise ValueError(f"negative shape entry in {tuple(shape)}")
    return packb({"dtype": dtype_name, "shape": [int(d) for d in shape]})


# fixed-width scalar type bytes → struct format
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# length-prefixed type bytes → (kind, struct format of the length)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data, self.i = data, 0

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.i:self.i + n]
        self.i += n
        return out

    def _items(self, kind: str, n: int) -> Any:
        if kind == "array":
            return [self.obj() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack map key of type {type(k).__name__}")
            out[k] = self.obj()
        return out

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t <= 0x8F:
            return self._items("map", t & 0x0F)
        if t <= 0x9F:
            return self._items("array", t & 0x0F)
        if t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        if t in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[t]
        if t in _FIXED:
            fmt = _FIXED[t]
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if t in _SIZED:
            kind, fmt = _SIZED[t]
            n = struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.take(n).decode("utf-8")
            return self._items(kind, n)
        raise ValueError(f"unsupported msgpack type byte {t:#04x}")


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for what :func:`packb` writes
    (and float32): arrays come back as lists, maps as dicts. Raises
    ``ValueError`` for truncated data, trailing bytes or an unsupported
    type byte."""
    r = _Reader(bytes(data))
    out = r.obj()
    if r.i != len(r.data):
        raise ValueError(f"{len(r.data) - r.i} trailing bytes after a msgpack object")
    return out


def unpack_header(data: bytes) -> Tuple[str, List[int]]:
    try:
        hdr = unpackb(data)
    except ValueError as exc:
        raise ValueError(f"malformed TPUT header: {exc}") from None
    if not isinstance(hdr, dict) or not isinstance(hdr.get("dtype"), str) \
            or not isinstance(hdr.get("shape"), list):
        raise ValueError(f"malformed TPUT header {hdr!r}")
    return hdr["dtype"], [int(d) for d in hdr["shape"]]


# ---------------------------------------------------------------- frames

def serialize(tensor: torch.Tensor, compress: bool = False,
              min_compress_bytes: int = 4096) -> bytes:
    """One tensor → a ``TPUT`` frame of its bytes: zstd-compressed where
    ``compress`` is set, the payload has at least ``min_compress_bytes``
    and the zstd frame is smaller (the JAX ``TensorSerializer``'s rule),
    raw otherwise."""
    t = tensor.detach().to("cpu").contiguous()
    name = wire_dtype_name(t.dtype)
    raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else np.empty(0, np.uint8)
    payload, flags = None, 0
    if compress and raw.size >= min_compress_bytes:
        packed = zstd.compress(raw)
        if packed is not None and len(packed) < raw.size:
            payload, flags = packed, _FLAG_ZSTD
    if payload is None:
        payload = raw.tobytes()
    header = pack_header(name, tuple(t.shape))
    return b"".join([_MAGIC, struct.pack("<BB", _VERSION, flags),
                     struct.pack("<I", len(header)), header, payload])


def _check_prefix(data: bytes) -> int:
    if len(data) < 10 or data[:4] != _MAGIC:
        raise ValueError("bad magic: not a TPUT tensor frame")
    version, flags = struct.unpack_from("<BB", data, 4)
    if version != _VERSION:
        raise ValueError(f"unsupported frame version {version}")
    return flags


def deserialize(data: bytes) -> torch.Tensor:
    """A ``TPUT`` frame → a CPU tensor of its dtype and shape. A zstd
    payload must declare the size the dtype and shape give, or it is
    refused before it is inflated. Raises :class:`CodecUnavailable` for a
    zstd frame made with a dictionary and ``ValueError`` for a malformed
    frame."""
    flags = _check_prefix(data)
    (hdr_len,) = struct.unpack_from("<I", data, 6)
    name, shape = unpack_header(data[10:10 + hdr_len])
    dtype = dtype_from_name(name)
    count = int(np.prod(shape)) if shape else 1
    size = count * dtype.itemsize
    payload = memoryview(data)[10 + hdr_len:]
    if flags & _FLAG_ZSTD:
        buf = zstd.decompress(payload, expected_size=size)
    else:
        if len(payload) != size:
            raise ValueError(f"TPUT payload of {len(payload)} bytes for {name} {shape}")
        buf = bytearray(payload)
    raw = torch.frombuffer(buf, dtype=torch.uint8) if size \
        else torch.empty(0, dtype=torch.uint8)
    return raw.view(dtype).reshape(shape)
