"""JPEG without Pillow: a baseline and progressive decoder.

The card's machine has no Pillow, which the JAX vision engine reads every
image through (``Image.open(f).convert("RGB")``). :func:`decode_jpeg`
gives the same ``[H, W, 3]`` uint8 array bit for bit as Pillow 12.1.0,
whose JPEG decoder is libjpeg-turbo 3.1.3 driven with libjpeg's defaults:
Pillow sets no decompression option outside draft mode, so the DCT method
is ``JDCT_ISLOW`` and ``do_fancy_upsampling`` is on (merged upsampling is
never taken), and block smoothing does not run because a whole file has
complete coefficients. The path it reproduces, all integer arithmetic:

- the islow IDCT (``jidctint.c``) with libjpeg's post-IDCT range limit;
- fancy upsampling (``jdsample.c``): h2v1, h2v2 and h1v2 with their
  alternating rounding biases, edge samples repeated; box upsampling where
  libjpeg takes it (a chroma plane two or fewer samples wide, factors
  other than 2);
- the fixed-point YCbCr->RGB tables (``jdcolor.c``), or no conversion
  where libjpeg guesses RGB (an Adobe APP14 transform 0, or component ids
  'R', 'G', 'B' without JFIF);
- grey repeated to three channels, as ``convert("RGB")`` does.

It reads SOF0, SOF1 and SOF2 at 8 bits, 1 or 3 components, any integral
sampling factors (1x1, 2x1, 1x2 and 2x2 luma are the ones cameras and
Pillow write), 8- and 16-bit DQT tables, DRI and RSTn, sequential files
in one or several scans, and progressive spectral selection and
successive approximation with EOB runs. APPn and COM segments are
skipped; EXIF orientation is ignored, as in the JAX engine. Anything else
(arithmetic coding, lossless, 12-bit, hierarchical, 4 components / CMYK,
a progressive file whose scans leave low coefficients incomplete, which
libjpeg block-smooths) raises :class:`JPEGUnsupported` naming what it
met; so do truncated and corrupt files.

:func:`decode_jpeg` runs the C++ decoder (``native/src/image_codec.cpp``);
:func:`decode_jpeg_plain` is its plain version in Python and numpy, with
the same integer arithmetic, taken with a logged warning where the
library cannot be built.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..native import host_lib


class JPEGUnsupported(ValueError):
    """A JPEG this decoder does not take, or bytes that are not a whole
    JPEG; the message names what it met."""


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


def _unsupported(msg: str) -> JPEGUnsupported:
    return JPEGUnsupported(f"unsupported JPEG: {msg}")


def _corrupt(msg: str) -> JPEGUnsupported:
    return JPEGUnsupported(f"corrupt JPEG: {msg}")


_U8P = ctypes.POINTER(ctypes.c_uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """The bytes of a JPEG → ``[H, W, 3]`` uint8 RGB, as Pillow's
    ``convert("RGB")`` gives it (see the module docstring)."""
    lib = host_lib("decode_jpeg", "decode_jpeg_plain")
    if lib is None:
        return decode_jpeg_plain(data)
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(_U8P)
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.jpeg_info(src, buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                       err, len(err))
    if rc == 0:
        out = np.empty((h.value, w.value, 3), np.uint8)
        rc = lib.jpeg_decode_rgb(src, buf.size, out.ctypes.data_as(_U8P), out.size,
                                 err, len(err))
    if rc:
        msg = err.value.decode(errors="replace")
        raise _unsupported(msg) if rc == -1 else _corrupt(msg)
    return out


# -- the plain version ---------------------------------------------------------

# zigzag index → natural (row-major) index
_NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
            12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
            35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
            58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

# Pillow's decompression-bomb error threshold (2 * MAX_IMAGE_PIXELS)
_MAX_PIXELS = 178956970

_UNSUPPORTED_SOF = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical (differential) JPEG", 0xC6: "hierarchical (differential) JPEG",
    0xC7: "hierarchical (differential) JPEG", 0xCD: "hierarchical (differential) JPEG",
    0xCE: "hierarchical (differential) JPEG", 0xCF: "hierarchical (differential) JPEG",
    0xC9: "arithmetic-coded JPEG", 0xCA: "arithmetic-coded JPEG",
    0xCB: "arithmetic-coded JPEG", 0xCC: "arithmetic-coded JPEG (DAC marker)",
    0xDE: "hierarchical JPEG (DHP marker)",
}


def _i16(v: int) -> int:
    """``static_cast<int16_t>``: libjpeg keeps coefficients in 16 bits."""
    return ((v + 32768) & 0xFFFF) - 32768


def _idct_limit_table() -> np.ndarray:
    t = np.arange(1024)
    return np.select([t < 128, t < 512, t < 896], [t + 128, 255, 0], t - 896).astype(np.uint8)


_IDCT_LIMIT = _idct_limit_table()


def _color_tables() -> Tuple[np.ndarray, ...]:
    def fix(v: float) -> int:
        return int(v * 65536.0 + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _color_tables()


class _Huffman:
    """A 16-bit lookahead table: the next 16 bits → (code length, value);
    length 0 is no code."""

    def __init__(self, counts: bytes, vals: bytes) -> None:
        lens = np.zeros(1 << 16, np.int64)
        out = np.zeros(1 << 16, np.int64)
        code = k = 0
        for n in range(1, 17):
            for _ in range(counts[n - 1]):
                if code >= 1 << n:      # refused before the first bad entry, as in C++
                    raise _corrupt("bogus Huffman table")
                lo, hi = code << (16 - n), (code + 1) << (16 - n)
                lens[lo:hi] = n
                out[lo:hi] = vals[k]
                code += 1
                k += 1
            if code >= 1 << n:
                raise _corrupt("bogus Huffman table")
            code <<= 1
        self.lens: List[int] = lens.tolist()
        self.vals: List[int] = out.tolist()


class _Bits:
    """An entropy-coded segment, unstuffed, read MSB first; reading past
    its end is a fault, as in the C++ reader."""

    def __init__(self, seg: bytes) -> None:
        self.data = seg + b"\0\0\0\0"
        self.end = 8 * len(seg)
        self.pos = 0

    def peek16(self) -> int:
        p = self.pos
        b = p >> 3
        return (int.from_bytes(self.data[b:b + 3], "big") >> (8 - (p & 7))) & 0xFFFF

    def skip(self, n: int) -> None:
        self.pos += n
        if self.pos > self.end:
            raise _corrupt("entropy data runs past its segment")

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        b = p >> 3
        v = (int.from_bytes(self.data[b:b + 4], "big") >> (32 - n - (p & 7))) & ((1 << n) - 1)
        self.skip(n)
        return v

    def receive_extend(self, s: int) -> int:
        if s == 0:
            return 0
        if s > 16:
            raise _corrupt("bad coefficient size")
        v = self.bits(s)
        return v - (1 << s) + 1 if v < 1 << (s - 1) else v

    def decode(self, h: _Huffman) -> int:
        look = self.peek16()
        n = h.lens[look]
        if not n:
            raise _corrupt("bad Huffman code")
        self.skip(n)
        return h.vals[look]


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int) -> None:
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None
        self.coef_bits = [-1] * 64
        self.dc_pred = 0
        self.dc_tbl = self.ac_tbl = 0


class _PlainDecoder:
    def __init__(self, data: bytes) -> None:
        self.d = data
        self.pos = 0
        self.progressive = False
        self.jfif = self.adobe = False
        self.adobe_transform = -1
        self.restart_interval = 0
        self.qt: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, _Huffman] = {}
        self.ac: Dict[int, _Huffman] = {}
        self.comps: List[_Component] = []
        self.width = self.height = 0

    # -- markers --------------------------------------------------------------

    def _u16(self, at: int) -> int:
        if at + 2 > len(self.d):
            raise _corrupt("truncated file")
        return (self.d[at] << 8) | self.d[at + 1]

    def _next_marker(self) -> int:
        d, n = self.d, len(self.d)
        while self.pos < n:
            if d[self.pos] != 0xFF:
                self.pos += 1
                continue
            p = self.pos + 1
            while p < n and d[p] == 0xFF:
                p += 1
            if p >= n:
                break
            if d[p] == 0:
                self.pos = p + 1
                continue
            self.pos = p + 1
            return d[p]
        raise _corrupt("truncated file: no EOI marker")

    def _segment(self) -> Tuple[int, int]:
        """(start, length) of the body of the marker segment at pos."""
        ln = self._u16(self.pos)
        if ln < 2 or self.pos + ln > len(self.d):
            raise _corrupt("truncated marker segment")
        at = self.pos + 2
        self.pos += ln
        return at, ln - 2

    def _table_marker(self, m: int, at: int, n: int) -> None:
        if m == 0xC4:
            self._dht(at, n)
        elif m == 0xDB:
            self._dqt(at, n)
        elif m == 0xDD:
            if n < 2:
                raise _corrupt("short DRI segment")
            self.restart_interval = self._u16(at)

    def read_header(self) -> None:
        d = self.d
        if len(d) < 4 or d[0] != 0xFF or d[1] != 0xD8:
            raise _corrupt("not a JPEG file (no SOI marker)")
        self.pos = 2
        while True:
            m = self._next_marker()
            if m == 0xD8:
                raise _corrupt("a second SOI marker")
            if m == 0xD9:
                raise _corrupt("EOI before the first scan")
            if 0xD0 <= m <= 0xD7 or m == 0x01:
                continue
            at, n = self._segment()
            if m in (0xC0, 0xC1, 0xC2):
                self._sof(m, at, n)
            elif m in _UNSUPPORTED_SOF:
                raise _unsupported(_UNSUPPORTED_SOF[m])
            elif m == 0xE0:
                if n >= 14 and d[at:at + 5] == b"JFIF\0":
                    self.jfif = True
            elif m == 0xEE:
                if n >= 12 and d[at:at + 5] == b"Adobe":
                    self.adobe, self.adobe_transform = True, d[at + 11]
            elif m == 0xDA:
                if not self.comps:
                    raise _corrupt("SOS before SOF")
                self._sos(at, n)
                # every block of the first scan takes at least one bit
                if self._scan_blocks() > 8 * (len(d) - self.pos):
                    raise _corrupt("truncated file: too little entropy data for the image size")
                return
            else:
                self._table_marker(m, at, n)

    def _sof(self, marker: int, at: int, n: int) -> None:
        d = self.d
        if self.comps:
            raise _corrupt("a second SOF marker")
        if n < 6:
            raise _corrupt("short SOF segment")
        precision, ncomp = d[at], d[at + 5]
        self.height, self.width = self._u16(at + 1), self._u16(at + 3)
        if precision != 8:
            raise _unsupported(f"{precision}-bit JPEG")
        if ncomp == 4:
            raise _unsupported("4-component (CMYK / YCCK) JPEG")
        if ncomp not in (1, 3):
            raise _unsupported(f"{ncomp}-component JPEG")
        if self.height == 0:
            raise _unsupported("JPEG whose height comes in a DNL marker")
        if self.width == 0:
            raise _corrupt("zero image width")
        if self.width * self.height > _MAX_PIXELS:
            raise _unsupported("JPEG larger than 178956970 pixels")
        if n < 6 + 3 * ncomp:
            raise _corrupt("short SOF segment")
        self.progressive = marker == 0xC2
        for i in range(ncomp):
            b = at + 6 + 3 * i
            c = _Component(d[b], d[b + 1] >> 4, d[b + 1] & 15, d[b + 2])
            if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
                raise _corrupt("bad sampling factors")
            if c.tq > 3:
                raise _corrupt("bad quantisation table number")
            self.comps.append(c)
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        if any(self.hmax % c.h or self.vmax % c.v for c in self.comps):
            raise _unsupported("JPEG with fractional sampling factors")
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            c.width = -(-self.width * c.h // self.hmax)
            c.height = -(-self.height * c.v // self.vmax)
            c.bw, c.bh = -(-c.width // 8), -(-c.height // 8)

    def _dqt(self, at: int, n: int) -> None:
        d, end = self.d, at + n
        while at < end:
            pq, tq = d[at] >> 4, d[at] & 15
            if tq > 3 or pq > 1:
                raise _corrupt("bad DQT table")
            at += 1
            need = 128 if pq else 64
            if at + need > end:
                raise _corrupt("short DQT segment")
            if pq:
                vals = np.frombuffer(d[at:at + 128], ">u2").astype(np.int64)
            else:
                vals = np.frombuffer(d[at:at + 64], np.uint8).astype(np.int64)
            table = np.zeros(64, np.int64)
            table[_NATURAL] = vals
            self.qt[tq] = table
            at += need

    def _dht(self, at: int, n: int) -> None:
        d, end = self.d, at + n
        while at < end:
            if at + 17 > end:
                raise _corrupt("short DHT segment")
            tc, th = d[at] >> 4, d[at] & 15
            if tc > 1 or th > 3:
                raise _corrupt("bad DHT table")
            counts = d[at + 1:at + 17]
            total = sum(counts)
            if total > 256 or at + 17 + total > end:
                raise _corrupt("bad DHT table")
            (self.ac if tc else self.dc)[th] = _Huffman(counts, d[at + 17:at + 17 + total])
            at += 17 + total

    def _sos(self, at: int, n: int) -> None:
        d = self.d
        if n < 1:
            raise _corrupt("short SOS segment")
        ns = d[at]
        if not 1 <= ns <= 4 or n < 4 + 2 * ns:
            raise _corrupt("bad SOS segment")
        scomps: List[_Component] = []
        for i in range(ns):
            cid, tables = d[at + 1 + 2 * i], d[at + 2 + 2 * i]
            match = [c for c in self.comps if c.id == cid]
            if not match:
                raise _corrupt("SOS names an unknown component")
            c = match[-1]
            if any(s is c for s in scomps):
                raise _corrupt("SOS names a component twice")
            c.dc_tbl, c.ac_tbl = tables >> 4, tables & 15
            if c.dc_tbl > 3 or c.ac_tbl > 3:
                raise _corrupt("bad Huffman table number")
            scomps.append(c)
        p = at + 1 + 2 * ns
        ss, se, ah, al = d[p], d[p + 1], d[p + 2] >> 4, d[p + 2] & 15
        if self.progressive:
            bad = se != 0 if ss == 0 else (se < ss or se > 63 or ns != 1)
            if bad or ah > 13 or al > 13:
                raise _corrupt("bad progressive scan parameters")
        else:
            ss, se, ah, al = 0, 63, 0, 0
        for c in scomps:
            if c.quant is None:     # libjpeg latches the table at the first scan
                if c.tq not in self.qt:
                    raise _corrupt("a scan uses an undefined quantisation table")
                c.quant = self.qt[c.tq].copy()
            need_dc = not self.progressive or (ss == 0 and ah == 0)
            need_ac = not self.progressive or ss > 0
            if (need_dc and c.dc_tbl not in self.dc) or (need_ac and c.ac_tbl not in self.ac):
                raise _corrupt("a scan uses an undefined Huffman table")
            if self.progressive:
                for k in range(ss, se + 1):
                    if ah != max(c.coef_bits[k], 0):
                        raise _corrupt("bogus progression")
                    c.coef_bits[k] = al
        if self.progressive and ss > 0 and scomps[0].coef_bits[0] < 0:
            raise _corrupt("AC scan before the DC scan")
        self.scan = (scomps, ss, se, ah, al)

    def _scan_blocks(self) -> int:
        scomps = self.scan[0]
        if len(scomps) == 1:
            return scomps[0].bw * scomps[0].bh
        return self.mcux * self.mcuy * sum(c.h * c.v for c in scomps)

    # -- entropy decoding -----------------------------------------------------

    def _entropy_segment(self) -> _Bits:
        """The unstuffed bytes from pos to the next marker; pos stands at
        the marker (or the end of the file)."""
        d, n, i = self.d, len(self.d), self.pos
        out = bytearray()
        while i < n:
            j = d.find(b"\xff", i)
            if j < 0:
                out += d[i:]
                i = n
                break
            out += d[i:j]
            if j + 1 < n and d[j + 1] == 0:
                out.append(0xFF)
                i = j + 2
                continue
            i = j
            break
        self.pos = i
        return _Bits(bytes(out))

    def decode_scan(self) -> None:
        scomps, ss, se, ah, al = self.scan
        for c in scomps:
            c.dc_pred = 0
        self.eobrun = 0
        br = self._entropy_segment()
        rst, todo = 0, self.restart_interval
        if len(scomps) == 1:
            c = scomps[0]
            mcus = [[(c, bx, by)] for by in range(c.bh) for bx in range(c.bw)]
        else:
            mcus = [[(c, mx * c.h + h, my * c.v + v) for c in scomps
                     for v in range(c.v) for h in range(c.h)]
                    for my in range(self.mcuy) for mx in range(self.mcux)]
        if not self.progressive:
            fn = self._block_baseline
        elif ss == 0:
            fn = self._dc_first if ah == 0 else self._dc_refine
        else:
            fn = self._ac_first if ah == 0 else self._ac_refine
        for mcu in mcus:
            if self.restart_interval:
                if todo == 0:
                    d, p = self.d, self.pos
                    while p + 1 < len(d) and d[p] == 0xFF and d[p + 1] == 0xFF:
                        p += 1
                    if p + 1 >= len(d) or d[p] != 0xFF or d[p + 1] != 0xD0 + rst:
                        raise _corrupt("missing restart marker")
                    rst = (rst + 1) & 7
                    self.pos = p + 2
                    br = self._entropy_segment()
                    for c in scomps:
                        c.dc_pred = 0
                    self.eobrun = 0
                    todo = self.restart_interval
                todo -= 1
            for c, bx, by in mcu:
                fn(br, c, c.coefs[by, bx], ss, se, al)

    def _block_baseline(self, br: _Bits, c: _Component, blk: np.ndarray, *_) -> None:
        c.dc_pred += br.receive_extend(br.decode(self.dc[c.dc_tbl]))
        blk[0] = _i16(c.dc_pred)
        ac = self.ac[c.ac_tbl]
        k = 1
        while k < 64:
            rs = br.decode(ac)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    raise _corrupt("coefficient index past 63")
                blk[_NATURAL[k]] = _i16(br.receive_extend(s))
            elif r != 15:
                break
            else:
                k += 15
            k += 1

    def _dc_first(self, br, c, blk, ss, se, al) -> None:
        c.dc_pred += br.receive_extend(br.decode(self.dc[c.dc_tbl]))
        blk[0] = _i16(c.dc_pred << al)

    def _dc_refine(self, br, c, blk, ss, se, al) -> None:
        if br.bits(1):
            blk[0] = _i16(int(blk[0]) | 1 << al)

    def _ac_first(self, br, c, blk, ss, se, al) -> None:
        if self.eobrun > 0:
            self.eobrun -= 1
            return
        ac = self.ac[c.ac_tbl]
        k = ss
        while k <= se:
            rs = br.decode(ac)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    raise _corrupt("coefficient index past 63")
                blk[_NATURAL[k]] = _i16(br.receive_extend(s) << al)
            elif r == 15:
                k += 15
            else:
                self.eobrun = (1 << r) + br.bits(r) - 1
                break
            k += 1

    def _ac_refine(self, br, c, blk, ss, se, al) -> None:
        p1, m1 = 1 << al, -(1 << al)
        ac = self.ac[c.ac_tbl]
        k = ss

        def correct(pos: int) -> None:
            v = int(blk[pos])
            if br.bits(1) and (v & p1) == 0:
                blk[pos] = _i16(v + (p1 if v >= 0 else m1))

        if self.eobrun == 0:
            while k <= se:
                rs = br.decode(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if br.bits(1) else m1
                elif r != 15:
                    self.eobrun = (1 << r) + br.bits(r)
                    break
                while k <= se:      # nonzero coefficients corrected, r zeros passed
                    pos = _NATURAL[k]
                    if blk[pos] != 0:
                        correct(pos)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > se:
                        raise _corrupt("coefficient index past the band")
                    blk[_NATURAL[k]] = s
                k += 1
        if self.eobrun > 0:
            while k <= se:
                pos = _NATURAL[k]
                if blk[pos] != 0:
                    correct(pos)
                k += 1
            self.eobrun -= 1

    # -- the whole file -------------------------------------------------------

    def decode(self) -> np.ndarray:
        # libjpeg's !has_multiple_scans: no scan may follow the first
        single_scan = not self.progressive and len(self.scan[0]) == len(self.comps)
        for c in self.comps:
            c.coefs = np.zeros((self.mcuy * c.v, self.mcux * c.h, 64), np.int64)
        while True:
            self.decode_scan()
            more = False
            while True:
                m = self._next_marker()
                if m == 0xD9:
                    break
                if 0xD0 <= m <= 0xD7 or m == 0x01:
                    continue
                at, n = self._segment()
                if m == 0xDA:
                    if single_scan:
                        raise _corrupt("a second scan after a scan of every component")
                    self._sos(at, n)
                    more = True
                    break
                if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                    raise _corrupt("a second SOF marker")
                self._table_marker(m, at, n)
            if not more:
                break
        for c in self.comps:
            if self.progressive:
                if c.coef_bits[0] < 0:
                    raise _corrupt("a component has no DC scan")
                if any(c.coef_bits[k] != 0 for k in range(1, 10)):
                    raise _unsupported(
                        "progressive JPEG whose scans leave low coefficients incomplete")
            elif c.quant is None:
                raise _corrupt("a component is in no scan")
        return self._output()

    def _output(self) -> np.ndarray:
        H, W = self.height, self.width
        full = []
        for c in self.comps:
            pix = _idct_islow(c.coefs[:c.bh, :c.bw].reshape(-1, 64), c.quant)
            plane = pix.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(
                c.bh * 8, c.bw * 8)
            full.append(_upsample(plane, c.width, c.height, self.hmax // c.h,
                                  self.vmax // c.v, W, H))
        if len(full) == 1:
            return np.repeat(full[0][..., None], 3, axis=2).astype(np.uint8)
        ids = [c.id for c in self.comps]
        if self.jfif:
            ycc = True
        elif self.adobe:
            ycc = self.adobe_transform != 0
        else:
            ycc = ids != [82, 71, 66]
        y, cb, cr = full
        if not ycc:
            return np.stack(full, axis=2).astype(np.uint8)
        r = y + _CR_R[cr]
        g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
        b = y + _CB_B[cb]
        return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)


def _idct_1d(x: np.ndarray, axis: int, shift: int) -> np.ndarray:
    """One pass of the islow IDCT along ``axis`` (8 long), int64 throughout."""
    v = [np.take(x, i, axis=axis) for i in range(8)]
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (v[0] + v[4]) << 13
    tmp1 = (v[0] - v[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * 9633
    tmp0, tmp1, tmp2, tmp3 = tmp0 * 2446, tmp1 * 16819, tmp2 * 25172, tmp3 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
    half = 1 << (shift - 1)
    out = [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
           tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]
    return np.stack([(o + half) >> shift for o in out], axis=axis)


def _idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """[N, 64] coefficients (natural order) → [N, 64] samples, through
    ``jidctint.c``'s two passes (columns, then rows) and range limit.
    libjpeg's all-zero-AC shortcuts give the same values, so none is
    taken here."""
    x = (coefs * quant).reshape(-1, 8, 8)        # [block, row, column]
    ws = _idct_1d(x, axis=1, shift=13 - 2)       # pass 1: down each column
    out = _idct_1d(ws, axis=2, shift=13 + 2 + 3)  # pass 2: along each row
    return _IDCT_LIMIT[out & 1023].reshape(-1, 64)


def _upsample(plane: np.ndarray, cw: int, ch: int, hr: int, vr: int, W: int,
              H: int) -> np.ndarray:
    """A component's samples → [H, W] int64, as ``jdsample.c`` does it."""
    p = plane.astype(np.int64)
    fancy_h = hr == 2 and cw > 2
    if hr == 1 and vr == 1:
        return p[:H, :W]
    if vr == 2 and (hr == 1 or fancy_h):
        y = np.arange(H)
        iy = y >> 1
        ny = np.clip(np.where(y & 1, iy + 1, iy - 1), 0, ch - 1)
        r0, r1 = p[iy], p[ny]
        if hr == 1:
            bias = np.where(y & 1, 2, 1)[:, None]
            return ((3 * r0 + r1 + bias) >> 2)[:, :W]
        cs = 3 * r0[:, :cw] + r1[:, :cw]
        x = np.arange(cw)
        left, right = cs[:, np.maximum(x - 1, 0)], cs[:, np.minimum(x + 1, cw - 1)]
        out = np.empty((H, 2 * cw), np.int64)
        out[:, 0::2] = (3 * cs + left + 8) >> 4
        out[:, 1::2] = (3 * cs + right + 7) >> 4
        return out[:, :W]
    if vr == 1 and fancy_h:
        r = p[:H, :cw]
        x = np.arange(cw)
        left, right = r[:, np.maximum(x - 1, 0)], r[:, np.minimum(x + 1, cw - 1)]
        out = np.empty((H, 2 * cw), np.int64)
        out[:, 0::2] = (3 * r + left + 1) >> 2
        out[:, 1::2] = (3 * r + right + 2) >> 2
        return out[:, :W]
    return p[np.arange(H) // vr][:, np.arange(W) // hr]


def decode_jpeg_plain(data: bytes) -> np.ndarray:
    """The plain version of :func:`decode_jpeg`, in Python and numpy."""
    dec = _PlainDecoder(bytes(data))
    dec.read_header()
    return dec.decode()
