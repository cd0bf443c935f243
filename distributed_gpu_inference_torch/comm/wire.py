"""Binary message framing of the pipeline's data plane: the ``TPUM``
message of ``distributed_gpu_inference_tpu/comm/wire.py``.

One message is a msgpack header and one ``TPUT`` tensor frame per tensor
(``utils/serialization.py``)::

    magic   b"TPUM"
    u8      version (=1)
    u32     header length
    bytes   msgpack header {"meta": {...}, "tensors": [name, ...]}
    repeat per tensor: u64 frame length + TPUT frame

The port writes uncompressed frames, so its bytes equal the JAX package's
``pack_message(..., compress=False)`` byte for byte; it reads a JAX
message with zstd frames wherever ``zstandard`` imports (a
``CodecUnavailable`` otherwise). Tensors come back as CPU tensors.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from distributed_gpu_inference_torch.utils.serialization import (
    deserialize,
    packb,
    serialize,
    unpackb,
)

_MAGIC = b"TPUM"
_VERSION = 1


def pack_message(meta: Dict[str, Any],
                 tensors: Optional[Mapping[str, Any]] = None) -> bytes:
    """``meta`` (msgpack-able) and named tensors (torch tensors or numpy
    arrays) → one message."""
    tensors = tensors or {}
    header = packb({"meta": meta, "tensors": list(tensors)})
    parts = [_MAGIC, struct.pack("<B", _VERSION), struct.pack("<I", len(header)), header]
    for t in tensors.values():
        # a numpy array is copied: it may be read-only, which torch refuses
        frame = serialize(t if isinstance(t, torch.Tensor)
                          else torch.from_numpy(np.array(t, order="C")))
        parts.append(struct.pack("<Q", len(frame)))
        parts.append(frame)
    return b"".join(parts)


def unpack_message(data: bytes) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One message → (meta, {name: CPU tensor}). Raises ``ValueError`` for
    a bad magic or version and for a cut or malformed message."""
    view = memoryview(data)
    if bytes(view[:4]) != _MAGIC:
        raise ValueError("bad magic: not a TPUM message")
    try:
        (version,) = struct.unpack_from("<B", view, 4)
        if version != _VERSION:
            raise ValueError(f"unsupported message version {version}")
        (hlen,) = struct.unpack_from("<I", view, 5)
        header = unpackb(bytes(view[9:9 + hlen]))
        off = 9 + hlen
        tensors: Dict[str, torch.Tensor] = {}
        for name in header["tensors"]:
            (flen,) = struct.unpack_from("<Q", view, off)
            off += 8
            if off + flen > len(view):
                raise ValueError(f"tensor {name!r} cut short")
            tensors[name] = deserialize(bytes(view[off:off + flen]))
            off += flen
        return header["meta"], tensors
    except (struct.error, KeyError, TypeError) as exc:
        raise ValueError(f"malformed TPUM message: {exc!r}") from None
