"""The proto3 wire codec of the data plane's IDL (``proto/inference.proto``).

The port's own copy of ``distributed_gpu_inference_tpu/comm/pb.py``: no
``protoc`` stubs, no ``google.protobuf``. A message is a sequence of
``(field_number << 3 | wire_type)`` tags; the IDL needs wire types 0
(varint: int32 / int64 / bool) and 2 (length-delimited: string / bytes /
message), and a decoder skips the fixed32 / fixed64 fields of a newer
peer. Messages are field specs and travel as plain dicts, encoded to the
same bytes the JAX package writes (``comm/grpc_plane.py`` plugs them in as
the request and response codecs).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

# field spec: {field_number: (name, kind)} where kind is one of
# "string", "bytes", "varint", "bool" or ("msg", spec)
Spec = Dict[int, Tuple[str, Any]]


def _encode_varint(value: int) -> bytes:
    if value < 0:
        # proto3 int32/int64 negatives ride as 10-byte two's complement
        value += 1 << 64
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _decode_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")
    if result >= 1 << 63:      # re-interpret as signed 64-bit
        result -= 1 << 64
    return result, pos


def _encode_into(spec: Spec, msg: Dict[str, Any], out: List[bytes]) -> int:
    """Append ``msg``'s fields to ``out`` → the bytes appended."""
    by_name = {name: (num, kind) for num, (name, kind) in spec.items()}
    n = 0
    for name, value in msg.items():
        if name not in by_name:
            raise KeyError(f"unknown field {name!r}")
        num, kind = by_name[name]
        if value is None:
            continue
        if kind == "string":
            data = value.encode("utf-8")
            if not data:
                continue
            parts = [_encode_varint(num << 3 | 2), _encode_varint(len(data)), data]
        elif kind == "bytes":
            if not value:
                continue
            parts = [_encode_varint(num << 3 | 2), _encode_varint(len(value)),
                     value if isinstance(value, bytes) else bytes(value)]
        elif kind == "varint":
            if value == 0:
                continue
            parts = [_encode_varint(num << 3 | 0), _encode_varint(int(value))]
        elif kind == "bool":
            if not value:
                continue
            parts = [_encode_varint(num << 3 | 0), _encode_varint(1)]
        elif isinstance(kind, tuple) and kind[0] == "msg":
            inner: List[bytes] = []
            size = _encode_into(kind[1], value, inner)
            parts = [_encode_varint(num << 3 | 2), _encode_varint(size), *inner]
        else:
            raise TypeError(f"unknown kind {kind!r}")
        out.extend(parts)
        n += sum(len(p) for p in parts)
    return n


def encode(spec: Spec, msg: Dict[str, Any]) -> bytes:
    """Dict → proto3 bytes. Default-valued fields are omitted (proto3)."""
    out: List[bytes] = []
    _encode_into(spec, msg, out)
    return b"".join(out)


def decode(spec: Spec, data: bytes) -> Dict[str, Any]:
    """proto3 bytes → dict with every spec'd field present (defaults
    filled), unknown fields skipped — standard proto forward compat."""
    buf = memoryview(data)
    out: Dict[str, Any] = {}
    for num, (name, kind) in spec.items():
        if kind == "string":
            out[name] = ""
        elif kind == "bytes":
            out[name] = b""
        elif kind == "varint":
            out[name] = 0
        elif kind == "bool":
            out[name] = False
        else:
            out[name] = None
    pos = 0
    while pos < len(buf):
        tag, pos = _decode_varint(buf, pos)
        num, wtype = tag >> 3, tag & 0x7
        field = spec.get(num)
        if wtype == 0:
            value, pos = _decode_varint(buf, pos)
            if field is not None:
                name, kind = field
                out[name] = bool(value) if kind == "bool" else value
        elif wtype == 2:
            ln, pos = _decode_varint(buf, pos)
            chunk = bytes(buf[pos:pos + ln])
            if len(chunk) != ln:
                raise ValueError("truncated length-delimited field")
            pos += ln
            if field is not None:
                name, kind = field
                if kind == "string":
                    out[name] = chunk.decode("utf-8")
                elif kind == "bytes":
                    out[name] = chunk
                elif isinstance(kind, tuple) and kind[0] == "msg":
                    out[name] = decode(kind[1], chunk)
                else:
                    raise ValueError(
                        f"field {name} kind {kind} can't be length-delimited"
                    )
        elif wtype == 5:       # fixed32 (unused by this IDL) — skip
            if pos + 4 > len(buf):
                raise ValueError("truncated fixed32 field")
            pos += 4
        elif wtype == 1:       # fixed64 — skip
            if pos + 8 > len(buf):
                raise ValueError("truncated fixed64 field")
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")
    return out


# --------------------------------------------------------------------------
# Message specs mirroring proto/inference.proto (field numbers must match)
# --------------------------------------------------------------------------

TENSOR = {1: ("frame", "bytes")}

CREATE_SESSION_REQUEST = {1: ("session_id", "string")}
CREATE_SESSION_RESPONSE = {1: ("session_id", "string"),
                           2: ("existing", "bool")}

FORWARD_REQUEST = {
    1: ("session_id", "string"),
    2: ("kv_len_after", "varint"),
    3: ("x", ("msg", TENSOR)),
    4: ("positions", ("msg", TENSOR)),
}
FORWARD_RESPONSE = {
    1: ("session_id", "string"),
    2: ("hidden", ("msg", TENSOR)),
    3: ("logits", ("msg", TENSOR)),
}

TRANSFER_KV_REQUEST = {1: ("handoff", "bytes")}
TRANSFER_KV_RESPONSE = {1: ("slot", "varint"), 2: ("bytes_received", "varint")}

CLOSE_SESSION_REQUEST = {1: ("session_id", "string")}
CLOSE_SESSION_RESPONSE = {1: ("status", "string")}

HEALTH_REQUEST: Spec = {}
HEALTH_RESPONSE = {
    1: ("status", "string"),
    2: ("layer_start", "varint"),
    3: ("layer_end", "varint"),
    4: ("is_first", "bool"),
    5: ("is_last", "bool"),
    6: ("active_sessions", "varint"),
    7: ("free_blocks", "varint"),
}


def serializer(spec):
    return lambda msg: encode(spec, msg)


def deserializer(spec):
    return lambda data: decode(spec, data)
