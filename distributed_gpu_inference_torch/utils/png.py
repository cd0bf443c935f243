"""PNG on the standard library (``zlib`` + ``struct``).

The card's machine has no Pillow, which the JAX package's image engines
use for their PNGs. :func:`encode_png` writes 8-bit RGB (one IDAT chunk,
filter 0 on every row), which any PNG reader opens. :func:`decode_png`
reads every PNG that Pillow 12.1.0 reads (grey, RGB, palette, grey +
alpha, RGBA; every bit depth the format allows; Adam7 interlace; every
row filter) into ``[H, W, 3]`` uint8 RGB equal to Pillow's
``convert("RGB")``:

- alpha is dropped and ``tRNS`` ignored; grey is repeated, a palette
  index is looked up;
- grey at 1, 2 or 4 bits is scaled to 0..255 (x 255, 85, 17);
- 16-bit RGB, RGBA and grey + alpha keep the high byte of each sample
  (Pillow's ``RGB;16B`` rawmodes); 16-bit grey opens in Pillow as
  ``I;16``, whose ``convert("RGB")`` clips the value to 255.

The row unfilter runs in C++ (``native/src/image_codec.cpp``
``png_unfilter``); :func:`decode_png_plain` takes its plain version,
:func:`_unfilter`, which :func:`decode_png` also takes, with a logged
warning, where the library cannot be built. A corrupt or truncated file
raises :class:`PNGUnsupported` (a ``ValueError``).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import List, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type → channels a pixel, and the bit depths the format allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Pillow's decompression-bomb error threshold (2 * MAX_IMAGE_PIXELS)
_MAX_PIXELS = 178956970
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


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


def _unfilter_rows(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters: the C++ ``png_unfilter``, or :func:`_unfilter`
    where the library cannot be built."""
    from ..native import host_lib

    lib = host_lib("png_unfilter", "utils.png._unfilter")
    if lib is None:
        return _unfilter(raw, h, stride, bpp)
    raw = np.ascontiguousarray(raw)
    out = np.empty((h, stride), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if lib.png_unfilter(raw.ctypes.data_as(u8p), h, stride, bpp, out.ctypes.data_as(u8p)):
        raise PNGUnsupported("unknown row filter")
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth):
    the plain version."""
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


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows → [h, w, ch] sample values."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2")[:, :w * ch].reshape(h, w, ch).astype(np.uint16)
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]   # one channel
    weights = 1 << np.arange(depth - 1, -1, -1)
    return (bits * weights).sum(axis=2).astype(np.uint8)[..., None]


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG → ``[H, W, 3]`` uint8 RGB (see the module
    docstring for what it takes)."""
    return _decode(data, _unfilter_rows)


def decode_png_plain(data: bytes) -> np.ndarray:
    """:func:`decode_png` with the plain row unfilter."""
    return _decode(data, _unfilter)


def _decode(data: bytes, unfilter) -> np.ndarray:
    chunks = _chunks(data)
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise PNGUnsupported("the first chunk is not IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if (ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or comp or filt
            or interlace > 1 or not w or not h):
        raise PNGUnsupported(
            f"PNG with bit depth {depth}, colour type {ctype}, compression {comp}, "
            f"filter {filt}, interlace {interlace}, size {w}x{h}: not a valid PNG header")
    if w * h > _MAX_PIXELS:
        raise PNGUnsupported(f"PNG of {w}x{h} pixels: more than Pillow opens "
                             f"({_MAX_PIXELS})")
    ch = _CHANNELS[ctype]
    passes = []                         # (x0, y0, dx, dy, width, height, stride)
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:           # an empty pass has no rows, not even filter bytes
            passes.append((x0, y0, dx, dy, pw, ph, -(-pw * ch * depth // 8)))
    expected = sum(ph * (1 + stride) for *_, ph, stride in passes)
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    try:
        # at most one byte past what the header needs: a zlib bomb stops there
        raw = np.frombuffer(zlib.decompressobj().decompress(idat, expected + 1), np.uint8)
    except zlib.error as exc:
        raise PNGUnsupported(f"corrupt image data: {exc}") from exc
    if raw.size != expected:
        raise PNGUnsupported(f"image data holds {raw.size}{'+' * (raw.size > expected)} "
                             f"bytes, expected {expected} for {w}x{h} at {depth} bits")
    bpp = max(1, ch * depth // 8)
    px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    offset = 0
    for x0, y0, dx, dy, pw, ph, stride in passes:
        n = ph * (1 + stride)
        rows = unfilter(raw[offset:offset + n], ph, stride, bpp)
        px[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        offset += n
    if ctype == 3:
        pal = np.frombuffer(b"".join(b for k, b in chunks if k == b"PLTE"), np.uint8)
        if pal.size % 3 or int(px.max(initial=0)) >= pal.size // 3:
            raise PNGUnsupported("palette missing or too short")
        return pal.reshape(-1, 3)[px[..., 0]]
    if depth == 16:
        # grey opens as I;16, whose convert("RGB") clips; the rest keep the high byte
        px = np.minimum(px, 255) if ctype == 0 else px >> 8
    elif depth < 8:
        px = px * (255 // ((1 << depth) - 1))
    px = px.astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
