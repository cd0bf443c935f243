"""PNG on the standard library (``zlib`` + ``struct``).

The card's machine has no Pillow, which the JAX package's image engines
use for their PNGs. :func:`encode_png` writes 8-bit RGB (one IDAT chunk,
filter 0 on every row), which any PNG reader opens. :func:`decode_png`
reads the common non-interlaced 8-bit files (grey, RGB, palette, grey +
alpha, RGBA; every row filter) into ``[H, W, 3]`` uint8 RGB the way
Pillow's ``convert("RGB")`` does: alpha is dropped, grey is repeated,
a palette index is looked up. Anything else raises :class:`PNGUnsupported`
(a ``ValueError``), so a caller can hand such a file to Pillow instead.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type → channels a pixel (8-bit samples)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PNGUnsupported(ValueError):
    """A PNG this reader does not take (or bytes that are not one)."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """``[H, W, 3]`` uint8 → the bytes of an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)    # filter byte 0 a row
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def _chunks(data: bytes) -> List[Tuple[bytes, bytes]]:
    if not data.startswith(SIGNATURE):
        raise PNGUnsupported("not a PNG file")
    out, i = [], len(SIGNATURE)
    while i + 12 <= len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        kind, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if len(body) != n:
            raise PNGUnsupported(f"truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[i + 8 + n:i + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise PNGUnsupported(f"bad CRC in the {kind!r} chunk")
        out.append((kind, body))
        i += 12 + n
        if kind == b"IEND":
            return out
    raise PNGUnsupported("no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].copy()
        if ftype == 2:
            line = line + prev
        elif ftype in (1, 3, 4):
            # these depend on the pixel to the left: a pass a pixel
            for x in range(0, stride, bpp):
                left = line[x - bpp:x] if x else np.zeros(bpp, np.uint8)
                up = prev[x:x + bpp]
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = ((left.astype(np.uint16) + up) // 2).astype(np.uint8)
                else:
                    ul = prev[x - bpp:x] if x else np.zeros(bpp, np.uint8)
                    pred = _paeth(left, up, ul)
                line[x:x + bpp] = line[x:x + bpp] + pred
        elif ftype != 0:
            raise PNGUnsupported(f"unknown row filter {ftype}")
        out[y] = line
        prev = line
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG → ``[H, W, 3]`` uint8 RGB (see the module
    docstring for what it takes)."""
    chunks = _chunks(data)
    if not chunks or chunks[0][0] != b"IHDR":
        raise PNGUnsupported("the first chunk is not IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise PNGUnsupported(
            f"PNG with bit depth {depth}, colour type {ctype}, interlace {interlace}: "
            "this reader takes non-interlaced 8-bit files")
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    ch = _CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as exc:
        raise PNGUnsupported(f"corrupt image data: {exc}") from exc
    if raw.size != h * (1 + w * ch):
        raise PNGUnsupported(f"image data holds {raw.size} bytes, expected "
                             f"{h * (1 + w * ch)}")
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:
        pal = np.frombuffer(b"".join(b for k, b in chunks if k == b"PLTE"), np.uint8)
        if pal.size % 3 or int(px.max(initial=0)) >= pal.size // 3:
            raise PNGUnsupported("palette missing or too short")
        return pal.reshape(-1, 3)[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
