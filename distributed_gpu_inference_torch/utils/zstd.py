"""Zstandard frames without ``zstandard``: the codec of the TPUT tensor
wire (``utils/serialization.py``).

The JAX package compresses every tensor frame of 4,096 bytes or more with
``zstandard`` at level 3 and keeps the result where it is smaller: spill
entries, stage hops, gRPC messages and KV handoffs. The card's machine has
no ``zstandard``, so the port carries its own codec:

- :func:`decompress` reads what ``zstandard.ZstdDecompressor().decompress``
  reads as the JAX reader calls it: the first frame of its input only
  (trailing bytes are ignored), the whole RFC 8878 frame format (every
  frame-header descriptor, window descriptors, single-segment frames,
  content-size fields of 1, 2, 4 or 8 bytes; raw, RLE and compressed
  blocks; raw, RLE, Huffman (1 or 4 streams, FSE-coded or direct weights)
  and treeless literals; predefined, RLE, FSE-compressed and repeat
  sequence tables; the three repeat offsets; overlapping matches; the
  XXH64 checksum where the header asks for one). A frame whose header
  declares no content size is refused, as ``zstandard`` refuses it ("could
  not determine content size in frame header"); a declared size of 0 reads
  as ``b""`` without looking further, as there. A frame with a dictionary ID
  raises :class:`CodecUnavailable` (the JAX package never writes one). A
  content size that differs from ``expected_size`` raises ``ValueError``
  before anything is allocated, so the TPUT reader, which knows the size
  from the frame's dtype and shape, refuses a bomb before inflating it.
  Truncated or corrupt input raises ``ValueError``. Block sizes follow
  libzstd's one-shot decoder, not the RFC: a raw or RLE block may exceed
  the block maximum, min(window, 128 KiB), and is bounded by the content
  size alone; a compressed block may neither hold nor restore more. Two
  cases are stricter than libzstd: a compressed block that restores past
  its maximum by at most 64 bytes and its literals' count, which libzstd
  reads where its output buffer has room and no encoder writes; and a
  Huffman literal stream that does not
  end exactly at its first bit, as RFC 8878 and libzstd's reference loop
  require; libzstd's fast four-stream loop does not check that, so a bit
  flipped there may be read by ``zstandard`` as other bytes and is refused
  here.
- :func:`compress` writes one single-segment frame with the content size
  and no checksum (``zstandard``'s defaults), whose size is within a few
  tenths of a percent of libzstd level 3's on tensor payloads. It does not
  match libzstd byte for byte; ``zstandard`` and both decoders here read
  it back to the input.

Both run in ``native/src/zstd_codec.cpp``. :func:`decompress_plain` is the
decoder's plain version, written from RFC 8878 in Python (slow: for small
frames, the tests, and a machine that cannot build the library). Where the
library does not build, :func:`decompress` takes it and :func:`compress`
returns ``None`` (the caller writes the frame uncompressed, which is the
JAX package's own rule where ``zstandard`` is missing); each is logged once
and counted in ``native.PLAIN_TAKEN``.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .. import native

_MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50  # the top 28 bits of a skippable frame's magic
_BLOCK_MAX = 128 * 1024
_U8P = ctypes.POINTER(ctypes.c_uint8)

# the C ABI's code for a frame that needs a dictionary
_DICTIONARY = -3


class CodecUnavailable(RuntimeError):
    """A frame needs what this process cannot decode: a zstd frame made
    with a dictionary."""


def _corrupt(msg: str) -> ValueError:
    return ValueError(f"corrupt zstd frame: {msg}")


class FrameHeader(NamedTuple):
    content_size: Optional[int]  # None where the header declares none
    window_size: int
    dictionary_id: int
    checksum: bool
    header_size: int             # bytes, the magic number included
    skippable: bool


def frame_header(frame: bytes) -> FrameHeader:
    """The header of the first frame of ``frame`` (RFC 8878 3.1.1.1). A
    skippable frame's content size is its user data's length, as libzstd
    gives it."""
    data = memoryview(frame)
    if len(data) < 4:
        raise _corrupt("too short for a frame header")
    (magic,) = struct.unpack_from("<I", data)
    if magic >> 4 == _SKIPPABLE >> 4:
        if len(data) < 8:
            raise _corrupt("truncated skippable frame header")
        (size,) = struct.unpack_from("<I", data, 4)
        return FrameHeader(size, 0, 0, False, 8, True)
    if magic != _MAGIC:
        raise _corrupt("not a zstd frame")
    if len(data) < 5:
        raise _corrupt("truncated frame header")
    descriptor = data[4]
    fcs_flag, single = descriptor >> 6, bool(descriptor & 0x20)
    if descriptor & 0x08:
        raise _corrupt("reserved bit set in the frame header")
    dict_bytes = (0, 1, 2, 4)[descriptor & 3]
    fcs_bytes = 1 if (fcs_flag == 0 and single) else (0, 2, 4, 8)[fcs_flag]
    size = 5 + (0 if single else 1) + dict_bytes + fcs_bytes
    if len(data) < size:
        raise _corrupt("truncated frame header")
    at, window = 5, 0
    if not single:
        exponent, mantissa = data[at] >> 3, data[at] & 7
        at += 1
        if 10 + exponent > 31:
            raise _corrupt("window too large")
        base = 1 << (10 + exponent)
        window = base + (base >> 3) * mantissa
    dict_id = int.from_bytes(data[at:at + dict_bytes], "little")
    at += dict_bytes
    content: Optional[int] = None
    if fcs_bytes:
        content = int.from_bytes(data[at:at + fcs_bytes], "little")
        if fcs_bytes == 2:
            content += 256
    if single:
        window = content
    return FrameHeader(content, window, dict_id, bool(descriptor & 4), size, False)


def _content_size(frame: bytes, expected_size: Optional[int]) -> int:
    """The checks both decoders make before decoding: the size to decode,
    0 where there is nothing to decode."""
    h = frame_header(frame)
    if h.dictionary_id:
        raise CodecUnavailable(
            f"zstd frame made with dictionary {h.dictionary_id}: dictionaries are not supported")
    if h.content_size is None:
        raise ValueError("could not determine content size in zstd frame header")
    if expected_size is not None and h.content_size != expected_size:
        raise ValueError(f"zstd frame declares {h.content_size} bytes, {expected_size} expected")
    if h.skippable and h.content_size:
        raise _corrupt("a skippable frame holds no content")
    return h.content_size


def decompress(frame: bytes, expected_size: Optional[int] = None) -> bytearray:
    """The content of the first zstd frame of ``frame`` (see the module
    docstring), through the native decoder; its plain version where the
    library does not build."""
    size = _content_size(frame, expected_size)
    if size == 0:
        return bytearray()
    lib = native.host_lib("zstd_decompress", "decompress_plain", native.ZSTD_SRC)
    if lib is None:
        return _decode_plain(bytes(frame), size)
    src = np.frombuffer(frame, np.uint8)
    out = bytearray(size)
    dst = (ctypes.c_uint8 * size).from_buffer(out)
    err = ctypes.create_string_buffer(256)
    n = lib.zstd_decompress(src.ctypes.data_as(_U8P), src.size, dst, size, err, len(err))
    if n == _DICTIONARY:
        raise CodecUnavailable("zstd frame made with a dictionary")
    if n < 0:
        raise _corrupt(err.value.decode())
    return out


def compress(data: bytes) -> Optional[bytes]:
    """One zstd frame of ``data``, or ``None`` where the native library does
    not build (the caller then writes ``data`` uncompressed). It stands for
    libzstd's level 3, the only level the JAX package writes."""
    lib = native.host_lib("zstd_compress", "an uncompressed frame", native.ZSTD_SRC)
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)
    cap = int(lib.zstd_compress_bound(src.size))
    out = bytearray(cap)
    dst = (ctypes.c_uint8 * cap).from_buffer(out)
    err = ctypes.create_string_buffer(256)
    n = lib.zstd_compress(src.ctypes.data_as(_U8P), src.size, dst, cap, err, len(err))
    if n < 0:
        raise RuntimeError(f"zstd compression failed: {err.value.decode()}")
    del dst
    return bytes(memoryview(out)[:n])


def decompress_plain(frame: bytes, expected_size: Optional[int] = None) -> bytearray:
    """:func:`decompress` in Python alone."""
    size = _content_size(frame, expected_size)
    return bytearray() if size == 0 else _decode_plain(bytes(frame), size)


# ===================================================== the plain decoder
# Written from RFC 8878; section numbers in the comments are the RFC's.

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xxh_round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes) -> int:
    """XXH64 with seed 0, the content checksum's hash (3.1.1)."""
    n, i = len(data), 0
    if n >= 32:
        v = [(_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64]
        while i + 32 <= n:
            lanes = struct.unpack_from("<4Q", data, i)
            v = [_xxh_round(a, b) for a, b in zip(v, lanes)]
            i += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for lane in v:
            h = ((h ^ _xxh_round(0, lane)) * _P1 + _P4) & _M64
    else:
        h = _P5
    h = (h + n) & _M64
    while i + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, i)
        h = (_rotl(h ^ _xxh_round(0, lane), 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        (word,) = struct.unpack_from("<I", data, i)
        h = (_rotl(h ^ (word * _P1 & _M64), 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h = _rotl(h ^ (data[i] * _P5 & _M64), 11) * _P1 & _M64
        i += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


class _Backward:
    """A bitstream read from its end (4.1 / 4.2.1.3): the last byte's
    highest set bit marks where reading starts. ``left`` counts the bits
    still unread and goes below 0 where a read runs past the start (those
    bits read as zeros)."""

    def __init__(self, data: bytes) -> None:
        if not data or data[-1] == 0:
            raise _corrupt("bitstream without an end mark")
        self.data = data
        self.left = (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def peek(self, n: int) -> int:
        if n == 0:
            return 0
        lo = self.left - n
        if lo >= 0:
            word = int.from_bytes(self.data[lo >> 3:(lo >> 3) + 8], "little")
            return (word >> (lo & 7)) & ((1 << n) - 1)
        if self.left <= 0:
            return 0
        word = int.from_bytes(self.data[:8], "little") & ((1 << self.left) - 1)
        return word << -lo

    def read(self, n: int) -> int:
        value = self.peek(n)
        self.left -= n
        return value


def _read_distribution(data: bytes, max_symbol: int, max_log: int) -> Tuple[List[int], int, int]:
    """An FSE table description (4.1.1): the normalized counts (-1 for
    "less than 1"), the accuracy log and the bytes it takes."""
    if not data:
        raise _corrupt("truncated FSE table description")
    bits = int.from_bytes(data[:256], "little")  # a description is far shorter
    pos = 4
    log = (bits & 15) + 5
    if log > max_log:
        raise _corrupt(f"FSE accuracy log {log} above {max_log}")
    size = 1 << log
    remaining = size + 1
    threshold, width = size, log + 1
    counts: List[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise _corrupt("FSE table description has too many symbols")
        small = (bits >> pos) & (threshold - 1)
        top = 2 * threshold - 1 - remaining
        if small < top:
            value = small
            pos += width - 1
        else:
            value = (bits >> pos) & (2 * threshold - 1)
            if value >= threshold:
                value -= top
            pos += width
        prob = value - 1
        counts.append(prob)
        remaining -= abs(prob)
        while remaining < threshold:
            threshold >>= 1
            width -= 1
        if prob == 0:  # a run of zeros: 2-bit repeat flags, 3 = more follow
            while True:
                repeat = (bits >> pos) & 3
                pos += 2
                counts.extend([0] * repeat)
                if len(counts) > max_symbol + 1:
                    raise _corrupt("FSE table description has too many symbols")
                if repeat < 3:
                    break
        if (pos + 7) // 8 > len(data):
            raise _corrupt("truncated FSE table description")
    if remaining != 1:
        raise _corrupt("FSE table description does not sum to its size")
    return counts, log, (pos + 7) // 8


def _fse_table(counts: List[int], log: int) -> List[Tuple[int, int, int]]:
    """Decoding states (4.1.1): (symbol, bits to read, baseline) each."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
    step, pos = (size >> 1) + (size >> 3) + 3, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise _corrupt("FSE table spread does not close")
    next_state = [1 if c == -1 else c for c in counts]
    table = []
    for s in symbols:
        state = next_state[s]
        next_state[s] += 1
        nbits = log - (state.bit_length() - 1)
        table.append((s, nbits, (state << nbits) - size))
    return table


# 3.1.1.3.2.1.1: literal-length and match-length codes, baselines and
# extra bits; 3.1.1.3.2.2: the predefined distributions
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4),
    (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12),
    (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4),
    (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12),
    (8195, 13), (16387, 14), (32771, 15), (65539, 16)]
_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
               2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5
# (max code, max accuracy log, predefined counts and log) for LL, OF, ML
_KINDS = ((35, 9, _LL_DEFAULT, 6), (31, 8, _OF_DEFAULT, 5), (52, 9, _ML_DEFAULT, 6))


class _Frame:
    """What one frame's blocks hand to the next: the Huffman table, the
    three sequence tables and the repeat offsets."""

    def __init__(self) -> None:
        self.huffman: Optional[Tuple[int, List[int], List[int]]] = None
        self.tables: List[Optional[list]] = [None, None, None]
        self.offsets = [1, 4, 8]


def _huffman_table(data: bytes) -> Tuple[Tuple[int, List[int], List[int]], int]:
    """A Huffman tree description (4.2.1): (max bits, symbol and length by
    the next max-bits bits) and the bytes it takes."""
    head = data[0]
    if head >= 128:
        count = head - 127
        used = 1 + (count + 1) // 2
        if used > len(data):
            raise _corrupt("truncated Huffman weights")
        weights = []
        for i in range(count):
            byte = data[1 + i // 2]
            weights.append(byte >> 4 if i % 2 == 0 else byte & 15)
    else:
        used = 1 + head
        if head == 0 or used > len(data):
            raise _corrupt("truncated Huffman weights")
        counts, log, taken = _read_distribution(data[1:used], 12, 6)
        if taken >= head:
            raise _corrupt("Huffman weights without a bitstream")
        table = _fse_table(counts, log)
        bits = _Backward(data[1 + taken:used])
        states = [bits.read(log), bits.read(log)]
        weights = []
        turn = 0
        while True:  # two states in turn; past the stream's start, the other one ends it
            if len(weights) > 253:
                raise _corrupt("too many Huffman weights")
            symbol, nbits, base = table[states[turn]]
            weights.append(symbol)
            states[turn] = base + bits.read(nbits)
            if bits.left < 0:
                weights.append(table[states[1 - turn]][0])
                break
            turn = 1 - turn
    if any(w > 12 for w in weights):
        raise _corrupt("Huffman weight above 12")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise _corrupt("Huffman weights all zero")
    max_bits = total.bit_length()
    if max_bits > 12:
        raise _corrupt("Huffman code longer than 12 bits")
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise _corrupt("Huffman weights do not close the code")
    weights.append(rest.bit_length())
    longest = weights.count(1)
    if longest < 2 or longest % 2:
        raise _corrupt("Huffman code with an odd count of longest codes")
    symbols: List[int] = []
    lengths: List[int] = []
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                symbols += [s] * (1 << (w - 1))
                lengths += [max_bits + 1 - w] * (1 << (w - 1))
    return (max_bits, symbols, lengths), used


def _huffman_stream(table, data: bytes, count: int) -> bytearray:
    max_bits, symbols, lengths = table
    bits = _Backward(data)
    out = bytearray(count)
    for i in range(count):
        v = bits.peek(max_bits)
        out[i] = symbols[v]
        bits.left -= lengths[v]
    if bits.left != 0:
        raise _corrupt("Huffman stream not consumed exactly")
    return out


def _literals(frame: _Frame, block: bytes) -> Tuple[bytes, int]:
    """The literals section (3.1.1.3.1): the literals and its size."""
    kind, fmt = block[0] & 3, (block[0] >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if fmt in (0, 2):
            head, size = 1, block[0] >> 3
        else:
            head = 2 if fmt == 1 else 3
            if len(block) < head:
                raise _corrupt("truncated literals header")
            size = int.from_bytes(block[:head], "little") >> 4
        if size > _BLOCK_MAX:
            raise _corrupt("literals larger than a block")
        if kind == 0:
            if head + size > len(block):
                raise _corrupt("truncated raw literals")
            return block[head:head + size], head + size
        if head + 1 > len(block):
            raise _corrupt("truncated RLE literals")
        return bytes([block[head]]) * size, head + 1
    head, width = ((3, 10), (3, 10), (4, 14), (5, 18))[fmt]
    if len(block) < head:
        raise _corrupt("truncated literals header")
    word = int.from_bytes(block[:head], "little") >> 4
    size, csize = word & ((1 << width) - 1), word >> width
    if size > _BLOCK_MAX:
        raise _corrupt("literals larger than a block")
    if head + csize > len(block):
        raise _corrupt("truncated compressed literals")
    body = block[head:head + csize]
    if kind == 2:
        frame.huffman, taken = _huffman_table(body)
        body = body[taken:]
    elif frame.huffman is None:
        raise _corrupt("treeless literals with no table before them")
    if fmt == 0:
        return bytes(_huffman_stream(frame.huffman, body, size)), head + csize
    if size < 6 or len(body) < 10:
        raise _corrupt("four literal streams too short")
    sizes = list(struct.unpack_from("<3H", body))
    sizes.append(len(body) - 6 - sum(sizes))
    if sizes[3] < 0:
        raise _corrupt("literal jump table past its section")
    quarter = (size + 3) // 4
    counts = [quarter, quarter, quarter, size - 3 * quarter]
    out, at = bytearray(), 6
    for n, count in zip(sizes, counts):
        out += _huffman_stream(frame.huffman, body[at:at + n], count)
        at += n
    return bytes(out), head + csize


def _sequence_table(frame: _Frame, kind: int, mode: int, data: bytes) -> int:
    max_code, max_log, default, default_log = _KINDS[kind]
    if mode == 0:
        frame.tables[kind] = _fse_table(default, default_log)
        return 0
    if mode == 1:
        if not data:
            raise _corrupt("truncated RLE sequence table")
        if data[0] > max_code:
            raise _corrupt("RLE sequence code out of range")
        frame.tables[kind] = [(data[0], 0, 0)]
        return 1
    if mode == 2:
        counts, log, taken = _read_distribution(data, max_code, max_log)
        frame.tables[kind] = _fse_table(counts, log)
        return taken
    if frame.tables[kind] is None:
        raise _corrupt("repeated sequence table with none before it")
    return 0


def _block(frame: _Frame, block: bytes, out: bytearray, limit: int) -> None:
    """A compressed block (3.1.1.3) appended to ``out``."""
    if not block:
        raise _corrupt("empty compressed block")
    start = len(out)
    literals, at = _literals(frame, block)
    rest = block[at:]
    if not rest:
        raise _corrupt("compressed block without a sequences section")
    nseq, at = rest[0], 1
    if nseq == 255:
        if len(rest) < 3:
            raise _corrupt("truncated sequences header")
        nseq, at = rest[1] + (rest[2] << 8) + 0x7F00, 3
    elif nseq >= 128:
        if len(rest) < 2:
            raise _corrupt("truncated sequences header")
        nseq, at = ((nseq - 128) << 8) + rest[1], 2
    lit_at = 0
    if nseq:
        if len(rest) < at + 1:
            raise _corrupt("truncated sequences header")
        modes = rest[at]
        at += 1
        if modes & 3:
            raise _corrupt("reserved bits set in the sequence modes")
        for kind, shift in ((0, 6), (1, 4), (2, 2)):
            at += _sequence_table(frame, kind, (modes >> shift) & 3, rest[at:])
        ll_t, of_t, ml_t = frame.tables
        bits = _Backward(rest[at:])
        states = [bits.read(len(t).bit_length() - 1) for t in (ll_t, of_t, ml_t)]
        reps = frame.offsets
        for i in range(nseq):
            ll_code, of_code, ml_code = ll_t[states[0]][0], of_t[states[1]][0], ml_t[states[2]][0]
            if ll_code > 35 or ml_code > 52 or of_code > 31:
                raise _corrupt("sequence code out of range")
            offset_value = (1 << of_code) + bits.read(of_code)
            base, extra = _ML[ml_code]
            match = base + bits.read(extra)
            base, extra = _LL[ll_code]
            lits = base + bits.read(extra)
            if bits.left < 0:
                raise _corrupt("sequences bitstream overrun")
            # 3.1.1.5: repeat offsets
            if offset_value > 3:
                offset = offset_value - 3
                reps[:] = [offset, reps[0], reps[1]]
            else:
                index = offset_value - (0 if lits == 0 else 1)
                if index == 0:
                    offset = reps[0]
                else:
                    offset = reps[0] - 1 if index == 3 else reps[index]
                    if offset == 0:
                        raise _corrupt("repeat offset of 0")
                    reps[:] = ([offset, reps[0], reps[2]] if index == 1
                               else [offset, reps[0], reps[1]])
            if lits > len(literals) - lit_at:
                raise _corrupt("sequence takes more literals than the block has")
            if len(out) + lits + match > limit:
                raise _corrupt("frame larger than its content size")
            out += literals[lit_at:lit_at + lits]
            lit_at += lits
            if offset > len(out):
                raise _corrupt("match offset before the start of the frame")
            src = len(out) - offset
            if offset >= match:
                out += out[src:src + match]
            else:  # overlapping: the pattern of ``offset`` bytes repeats
                pattern = out[src:]
                out += (pattern * (match // offset + 1))[:match]
            if len(out) - start > _BLOCK_MAX:
                raise _corrupt("block larger than 128 KiB")
            if i + 1 < nseq:
                for k, t in ((0, ll_t), (2, ml_t), (1, of_t)):
                    _, nbits, base = t[states[k]]
                    states[k] = base + bits.read(nbits)
                if bits.left < 0:
                    raise _corrupt("sequences bitstream overrun")
        if bits.left != 0:
            raise _corrupt("sequences bitstream not consumed exactly")
    elif at != len(rest):
        raise _corrupt("bytes after a sequences section without sequences")
    tail = literals[lit_at:]
    if len(out) + len(tail) > limit:
        raise _corrupt("frame larger than its content size")
    out += tail
    if len(out) - start > _BLOCK_MAX:
        raise _corrupt("block larger than 128 KiB")


def _decode_plain(data: bytes, size: int) -> bytearray:
    h = frame_header(data)
    frame, out = _Frame(), bytearray()
    block_max = min(h.window_size, _BLOCK_MAX)
    at = h.header_size
    while True:
        if len(data) - at < 3:
            raise _corrupt("truncated block header")
        word = int.from_bytes(data[at:at + 3], "little")
        at += 3
        last, kind, bsize = word & 1, (word >> 1) & 3, word >> 3
        if kind == 3:
            raise _corrupt("reserved block type")
        if kind == 1:
            if at >= len(data):
                raise _corrupt("truncated RLE block")
            if len(out) + bsize > size:
                raise _corrupt("frame larger than its content size")
            out += bytes([data[at]]) * bsize
            at += 1
        else:
            if len(data) - at < bsize:
                raise _corrupt("truncated block")
            if kind == 0:
                if len(out) + bsize > size:
                    raise _corrupt("frame larger than its content size")
                out += data[at:at + bsize]
            else:
                # a compressed block holds and restores at most the block
                # maximum; raw and RLE blocks are bounded by the content
                # size alone, as libzstd's one-shot decoder bounds them
                if bsize > block_max:
                    raise _corrupt("block larger than its maximum")
                start = len(out)
                _block(frame, data[at:at + bsize], out, size)
                if len(out) - start > block_max:
                    raise _corrupt("block restores more than its maximum")
            at += bsize
        if last:
            break
    if len(out) != size:
        raise _corrupt("frame shorter than its content size")
    if h.checksum:
        if len(data) - at < 4:
            raise _corrupt("truncated checksum")
        if xxh64(bytes(out)) & 0xFFFFFFFF != int.from_bytes(data[at:at + 4], "little"):
            raise _corrupt("restored data does not match its checksum")
    return out
