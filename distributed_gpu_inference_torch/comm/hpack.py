"""HPACK (RFC 7541): the header compression of the port's HTTP/2
(``comm/h2.py``), on the standard library.

- Prefix integers (§5.1), bounded: a value past 2**32 or a continuation
  longer than 6 bytes is refused.
- The 61-entry static table (Appendix A) and the dynamic table (§2.3, §4):
  entries cost ``len(name) + len(value) + 32`` bytes, the oldest are
  evicted past the table's size, and a size update (§6.3) may only open a
  header block and may not exceed the bound the decoder advertised.
- All representations (§6): indexed fields, literals with incremental
  indexing, without indexing and never indexed, each with an indexed or a
  literal name.
- The Huffman code of Appendix B. The code is canonical, so the 257 code
  lengths in :data:`_CODE_LENGTHS` define it; padding longer than 7 bits,
  padding that is not all ones, and EOS inside a string are errors
  (§5.2).

The :class:`Encoder` writes every field as a literal without indexing, its
strings raw (no Huffman), which every decoder takes, so it keeps no
dynamic table. A malformed block raises :class:`HPACKError`, which the
connection answers with ``COMPRESSION_ERROR``.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

Header = Tuple[str, str]

#: Appendix A
STATIC_TABLE: Tuple[Header, ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"),
    (":status", "200"), (":status", "204"), (":status", "206"), (":status", "304"),
    (":status", "400"), (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""), ("cookie", ""),
    ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)

#: Appendix B: the code length of each symbol 0..255 and EOS (256)
_CODE_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,     # 0-15
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,     # 16-31
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,             # ' ' - '/'
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,                  # '0' - '?'
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,                    # '@' - 'O'
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,                 # 'P' - '_'
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,                    # '`' - 'o'
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,                # 'p' - 127
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,     # 128-143
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,     # 144-159
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,     # 160-175
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,     # 176-191
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,     # 192-207
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,     # 208-223
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,     # 224-239
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,     # 240-255
    30,                                                                 # EOS
)
EOS = 256
MAX_INT = 1 << 32           # the largest prefix integer a decoder takes
_MAX_INT_BYTES = 6          # continuation bytes past the prefix


class HPACKError(ValueError):
    """A malformed header block (the connection's ``COMPRESSION_ERROR``)."""


def _canonical_codes() -> List[Tuple[int, int]]:
    """(code, length) of each symbol, assigned canonically: by length, then
    by symbol, each code the previous one plus one, shifted left as the
    length grows."""
    order = sorted(range(len(_CODE_LENGTHS)), key=lambda s: (_CODE_LENGTHS[s], s))
    codes: List[Tuple[int, int]] = [(0, 0)] * len(_CODE_LENGTHS)
    code, prev = 0, _CODE_LENGTHS[order[0]]
    for i, sym in enumerate(order):
        n = _CODE_LENGTHS[sym]
        if i:
            code = (code + 1) << (n - prev)
        codes[sym], prev = (code, n), n
    return codes


HUFFMAN_CODES = _canonical_codes()
# the last code of a complete canonical code is all ones: EOS, 30 bits
assert HUFFMAN_CODES[EOS] == ((1 << 30) - 1, 30)
_DECODE: Dict[Tuple[int, int], int] = {(n, c): s for s, (c, n) in enumerate(HUFFMAN_CODES)}
_MIN_LEN = min(_CODE_LENGTHS)


def huffman_encode(data: bytes) -> bytes:
    acc, nbits, out = 0, 0, bytearray()
    for b in data:
        code, n = HUFFMAN_CODES[b]
        acc = (acc << n) | code
        nbits += n
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:
        # pad with the most significant bits of EOS (all ones)
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code, n = 0, 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            n += 1
            if n < _MIN_LEN:
                continue
            sym = _DECODE.get((n, code))
            if sym is None:
                if n >= 30:
                    raise HPACKError("invalid Huffman code")
                continue
            if sym == EOS:
                raise HPACKError("EOS symbol inside a Huffman string")
            out.append(sym)
            code, n = 0, 0
    if n > 7:
        raise HPACKError("Huffman padding longer than 7 bits")
    if code != (1 << n) - 1:
        raise HPACKError("Huffman padding is not the most significant bits of EOS")
    return bytes(out)


def encode_int(value: int, prefix: int, first: int = 0) -> bytes:
    """``value`` in an N-bit prefix (§5.1); ``first`` holds the bits above
    the prefix."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(buf: memoryview, pos: int, prefix: int) -> Tuple[int, int]:
    """→ (value, position after it)."""
    if pos >= len(buf):
        raise HPACKError("header block ends inside an integer")
    limit = (1 << prefix) - 1
    value = buf[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    for _ in range(_MAX_INT_BYTES):
        if pos >= len(buf):
            raise HPACKError("header block ends inside an integer")
        b = buf[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            if value > MAX_INT:
                raise HPACKError(f"integer {value} past the bound {MAX_INT}")
            return value, pos
    raise HPACKError("integer encoding longer than the bound")


def encode_string(data: bytes, huffman: bool = False) -> bytes:
    if huffman:
        data = huffman_encode(data)
    return encode_int(len(data), 7, 0x80 if huffman else 0) + data


def decode_string(buf: memoryview, pos: int) -> Tuple[bytes, int]:
    if pos >= len(buf):
        raise HPACKError("header block ends before a string")
    huffman = bool(buf[pos] & 0x80)
    n, pos = decode_int(buf, pos, 7)
    if pos + n > len(buf):
        raise HPACKError("string runs past the header block")
    raw = bytes(buf[pos:pos + n])
    return (huffman_decode(raw) if huffman else raw), pos + n


def entry_size(name: str, value: str) -> int:
    return len(name.encode("utf-8", "surrogateescape")) + \
        len(value.encode("utf-8", "surrogateescape")) + 32


class DynamicTable:
    """The FIFO of §2.3.2: index 1 is the newest entry."""

    def __init__(self, max_size: int = 4096) -> None:
        self.max_size = max_size
        self.size = 0
        self.entries: "deque[Header]" = deque()

    def add(self, name: str, value: str) -> None:
        need = entry_size(name, value)
        while self.entries and self.size + need > self.max_size:
            self._evict()
        if need <= self.max_size:
            self.entries.appendleft((name, value))
            self.size += need
        # an entry larger than the table empties it and is not added (§4.4)

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        while self.size > max_size:
            self._evict()

    def _evict(self) -> None:
        name, value = self.entries.pop()
        self.size -= entry_size(name, value)

    def get(self, index: int) -> Header:
        """``index`` in the joint address space of §2.3.3."""
        if index <= 0:
            raise HPACKError("header index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if i >= len(self.entries):
            raise HPACKError(f"header index {index} past the tables")
        return self.entries[i]


def _text(b: bytes) -> str:
    # names and values are octets; surrogateescape keeps every byte
    return b.decode("utf-8", "surrogateescape")


class Decoder:
    """Decodes header blocks of one connection, in order.
    ``max_table_size`` is the bound this side advertised
    (SETTINGS_HEADER_TABLE_SIZE)."""

    def __init__(self, max_table_size: int = 4096) -> None:
        self.max_table_size = max_table_size
        self.table = DynamicTable(max_table_size)

    def decode(self, block: bytes) -> List[Header]:
        buf = memoryview(block)
        pos, out, opening = 0, [], True
        while pos < len(buf):
            b = buf[pos]
            if b & 0x80:                                    # indexed field
                index, pos = decode_int(buf, pos, 7)
                out.append(self.table.get(index))
            elif b & 0xE0 == 0x20:                          # table size update
                if not opening:
                    raise HPACKError("dynamic table size update after a field")
                size, pos = decode_int(buf, pos, 5)
                if size > self.max_table_size:
                    raise HPACKError(f"table size update {size} past the bound "
                                     f"{self.max_table_size}")
                self.table.resize(size)
                continue
            else:
                indexing = bool(b & 0x40)
                index, pos = decode_int(buf, pos, 6 if indexing else 4)
                if index:
                    name = self.table.get(index)[0]
                else:
                    raw, pos = decode_string(buf, pos)
                    name = _text(raw)
                raw, pos = decode_string(buf, pos)
                value = _text(raw)
                if indexing:
                    self.table.add(name, value)
                out.append((name, value))
            opening = False
        return out


class Encoder:
    """Literal fields without indexing and raw strings: no dynamic table
    to keep. After the peer lowers its table size, the next block opens
    with a size update, as §4.2 asks."""

    def __init__(self) -> None:
        self._pending: Optional[int] = None

    def set_max_table_size(self, size: int) -> None:
        self._pending = size

    def encode(self, headers: Sequence[Header]) -> bytes:
        out: List[bytes] = []
        if self._pending is not None:
            out.append(encode_int(min(self._pending, 4096), 5, 0x20))
            self._pending = None
        for name, value in headers:
            out.append(b"\x00")
            out.append(encode_string(name.encode("utf-8", "surrogateescape")))
            out.append(encode_string(value.encode("utf-8", "surrogateescape")))
        return b"".join(out)
