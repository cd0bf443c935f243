"""The port's host image path without Pillow, held to Pillow 12.1.0.

- ``utils/jpeg.py``: the C++ decoder (``native/src/image_codec.cpp``)
  against its plain version ``decode_jpeg_plain`` and against
  ``np.asarray(Image.open(f).convert("RGB"))``, bit for bit, over seeded
  images at qualities 10-100, the four luma samplings (1x1, 2x1, 2x2 from
  Pillow; 1x2 and others from the small baseline writer below, which
  Pillow then decodes), progressive on and off, ``optimize``, restart
  markers, 16-bit DQT tables, sizes down to 1 x 1, and grey; every refused
  kind by name; truncated and corrupt files, Huffman tables that break
  the Kraft inequality and headers that declare a huge image, which raise
  (in a child process, so a crash would show as one; once more against an
  AddressSanitizer build where ``$CXX`` has the runtime);
- ``utils/resize.py``: native and plain against ``Image.resize`` over a
  grid of sizes, up and down;
- ``utils/png.py``: every colour type and depth, Adam7, against Pillow;
- the fixtures of ``scripts/make_image_fixtures.py``: rebuilt, the same
  bytes and manifest; decoded and resized to the manifest's digests;
- without a compiler each host function takes its plain version, said in
  a warning that names it.
"""

import hashlib
import io
import json
import logging
import math
import os
import pathlib
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from distributed_gpu_inference_torch import native as tnative
from distributed_gpu_inference_torch.utils import png as tpng
from distributed_gpu_inference_torch.utils.jpeg import (
    JPEGUnsupported,
    decode_jpeg,
    decode_jpeg_plain,
    is_jpeg,
)
from distributed_gpu_inference_torch.utils.png import PNGUnsupported, decode_png
from distributed_gpu_inference_torch.utils.resize import resize_bicubic, resize_bicubic_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "images"
sys.path.insert(0, str(ROOT / "scripts"))
import make_image_fixtures as mif  # noqa: E402

needs_cxx = pytest.mark.skipif(shutil.which(os.environ.get("CXX", "g++")) is None,
                               reason="no C++ compiler")


def pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def seeded(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    return mif.synth(h, w, seed, channels, noise=12.0).astype(np.uint8)


def pillow_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def assert_three_agree(data: bytes) -> np.ndarray:
    ref = pillow_rgb(data)
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref), int((got != ref).any(axis=2).sum())
    assert np.array_equal(decode_jpeg_plain(data), ref)
    return got


# -- a small baseline JPEG writer: samplings and colour spaces Pillow does not write ---

_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
           12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
           35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
           58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
# flat Huffman tables: every DC category 4 bits, every AC (run, size) 8 bits
_DC_SYMS = list(range(12))
_AC_SYMS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
_DCT = np.array([[(math.sqrt(0.125) if u == 0 else 0.5) * math.cos((2 * x + 1) * u * math.pi / 16)
                  for x in range(8)] for u in range(8)])


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class _BitWriter:
    def __init__(self) -> None:
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, nbits: int) -> None:
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self) -> bytes:
        if self.n:
            self.put(0x7F, 8 - self.n)      # pad with ones
        out, self.out = bytes(self.out), bytearray()
        return out


def _category(v: int):
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def write_baseline_jpeg(img: np.ndarray, factors, quality_q: int = 6, ids=(1, 2, 3),
                        ycc: bool = True, jfif: bool = False, adobe=None,
                        interleaved: bool = True, restart: int = 0) -> bytes:
    """[H, W, C] uint8 → a baseline JPEG with the given (h, v) sampling
    factor of each component, one flat quantisation table of ``quality_q``."""
    h_img, w_img, nc = img.shape
    x = img.astype(np.float64)
    if nc == 3 and ycc:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        x = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                      -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                      0.5 * r - 0.418688 * g - 0.081312 * b + 128], axis=2)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    q = np.full(64, quality_q, np.int64)
    comps = []
    for c, (fh, fv) in enumerate(factors):
        cw, ch = -(-w_img * fh // hmax), -(-h_img * fv // vmax)
        sx, sy = hmax // fh, vmax // fv
        pad = np.pad(x[..., c], ((0, mcuy * 8 * vmax - h_img), (0, mcux * 8 * hmax - w_img)),
                     mode="edge")
        sub = pad.reshape(pad.shape[0] // sy, sy, pad.shape[1] // sx, sx).mean(axis=(1, 3))
        blocks = sub.reshape(sub.shape[0] // 8, 8, sub.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        coefs = np.einsum("ux,abxy,vy->abuv", _DCT, blocks - 128.0, _DCT).reshape(
            blocks.shape[0], blocks.shape[1], 64)
        comps.append({"h": fh, "v": fv, "bw": -(-cw // 8), "bh": -(-ch // 8),
                      "q": np.round(coefs / q).astype(np.int64), "pred": 0})
    bw = _BitWriter()

    def block(c, bx, by):
        zz = c["q"][by, bx][_ZIGZAG]
        s, bits = _category(int(zz[0]) - c["pred"])
        c["pred"] = int(zz[0])
        bw.put(_DC_SYMS.index(s), 4)
        bw.put(bits, s)
        run = 0
        last = max([k for k in range(1, 64) if zz[k]] or [0])
        for k in range(1, last + 1):
            if zz[k] == 0:
                run += 1
                continue
            while run > 15:
                bw.put(_AC_SYMS.index(0xF0), 8)
                run -= 16
            s, bits = _category(int(zz[k]))
            bw.put(_AC_SYMS.index((run << 4) | s), 8)
            bw.put(bits, s)
            run = 0
        if last < 63:
            bw.put(_AC_SYMS.index(0x00), 8)

    def scan(units):
        data, rst = bytearray(), 0
        for i, unit in enumerate(units):
            if restart and i and i % restart == 0:
                data += bw.flush() + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                for c in comps:
                    c["pred"] = 0
            for c, bx, by in unit:
                block(c, bx, by)
        return bytes(data + bw.flush())

    dqt = _segment(0xDB, bytes([0]) + bytes(q[_ZIGZAG].tolist()))
    sof = _segment(0xC0, struct.pack(">BHHB", 8, h_img, w_img, nc) + b"".join(
        bytes([ids[c], (f[0] << 4) | f[1], 0]) for c, f in enumerate(factors)))
    dht = _segment(0xC4, bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(_DC_SYMS)
                   + bytes([0x10]) + bytes([0] * 7 + [len(_AC_SYMS)] + [0] * 8)
                   + bytes(_AC_SYMS))
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe]))
    out += dqt + sof + dht
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if interleaved and nc > 1:     # a scan of one component is never interleaved
        units = [[(c, mx * c["h"] + hh, my * c["v"] + vv) for c in comps
                  for vv in range(c["v"]) for hh in range(c["h"])]
                 for my in range(mcuy) for mx in range(mcux)]
        sos = bytes([nc]) + b"".join(bytes([ids[c], 0x00]) for c in range(nc)) + b"\x00\x3f\x00"
        out += _segment(0xDA, sos) + scan(units)
    else:
        for ci, c in enumerate(comps):
            c["pred"] = 0
            units = [[(c, bx, by)] for by in range(c["bh"]) for bx in range(c["bw"])]
            out += _segment(0xDA, bytes([1, ids[ci], 0x00]) + b"\x00\x3f\x00") + scan(units)
    return out + b"\xff\xd9"


# -- the decoder against Pillow and its plain version ---------------------------------

SIZES = [(1, 1), (1, 9), (7, 1), (2, 3), (8, 8), (9, 17), (16, 16), (17, 33), (31, 24),
         (40, 57)]


@needs_cxx
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", [0, 1, 2, "grey"])
def test_pillow_jpegs_decode_as_pillow_does(size, subsampling):
    h, w = size
    img = seeded(h, w, h * 100 + w)
    n = 0
    for quality in (10, 35, 75, 95, 100):
        for progressive in (False, True):
            kw = {"quality": quality, "progressive": progressive, "optimize": progressive}
            if subsampling == "grey":
                src = img[..., 0]
            else:
                src = img
                kw["subsampling"] = subsampling
            if quality == 75:
                kw["restart_marker_blocks"] = 2
            data = pillow_jpeg(src, **kw)
            assert data[:3] == b"\xff\xd8\xff" and is_jpeg(data)
            assert_three_agree(data)
            n += 1
    assert n == 10


@needs_cxx
@pytest.mark.parametrize("factors", [
    ((1, 2), (1, 1), (1, 1)),       # 4:4:0, the 1x2 luma a rotated phone photo has
    ((2, 2), (1, 1), (1, 1)),       # 4:2:0
    ((2, 1), (1, 1), (1, 1)),       # 4:2:2
    ((4, 1), (1, 1), (1, 1)),       # 4:1:1: box upsampling
    ((2, 2), (1, 2), (2, 1)),       # mixed chroma factors
    ((1, 1), (1, 1), (1, 1)),
], ids=["1x2", "2x2", "2x1", "4x1", "mixed", "1x1"])
@pytest.mark.parametrize("size", [(1, 1), (3, 5), (16, 16), (21, 35), (33, 18)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_other_samplings_decode_as_pillow_does(factors, size):
    img = seeded(*size, seed=size[0] * 7 + size[1])
    for q in (2, 9):
        assert_three_agree(write_baseline_jpeg(img, factors, quality_q=q, jfif=True))


@needs_cxx
def test_colour_spaces_scans_restarts_and_tables_as_pillow_does():
    img = seeded(27, 45, 5)
    one = ((1, 1), (1, 1), (1, 1))
    # libjpeg's colour-space guess: Adobe transform 0 and 'R','G','B' ids are RGB
    for kw in ({"adobe": 0, "ycc": False}, {"adobe": 1}, {"ids": (82, 71, 66), "ycc": False},
               {"ids": (82, 71, 66), "jfif": True}, {"ids": (5, 9, 200)}):
        assert_three_agree(write_baseline_jpeg(img, one, **kw))
    assert_three_agree(pillow_jpeg(img, keep_rgb=True))
    # a sequential file in three scans; restart markers in a writer of our own
    assert_three_agree(write_baseline_jpeg(img, ((2, 2), (1, 1), (1, 1)), interleaved=False))
    assert_three_agree(write_baseline_jpeg(img, ((2, 1), (1, 1), (1, 1)), restart=3))
    assert_three_agree(write_baseline_jpeg(img, ((2, 2), (1, 1), (1, 1)), interleaved=False,
                                           restart=5))
    # a grey file whose one component has factors 2x2
    assert_three_agree(write_baseline_jpeg(img[..., :1], ((2, 2),)))
    # 16-bit DQT tables (values past 255) make Pillow write SOF1
    coarse = pillow_jpeg(img, qtables=[[300 + i for i in range(64)], [2] * 64], subsampling=2)
    assert b"\xff\xc1" in coarse
    assert_three_agree(coarse)
    # restart markers every row of MCUs, and a SOF0 file relabelled SOF1
    rst = pillow_jpeg(img, restart_marker_rows=1, subsampling=1)
    assert b"\xff\xdd" in rst and b"\xff\xd0" in rst
    assert_three_agree(rst)
    sof0 = pillow_jpeg(img, quality=60)
    assert_three_agree(sof0.replace(b"\xff\xc0", b"\xff\xc1", 1))
    # APPn and COM segments are skipped; EXIF orientation is ignored
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", exif=exif.tobytes(), comment=b"a comment",
                              icc_profile=b"\0" * 300)
    assert_three_agree(buf.getvalue())


@needs_cxx
def test_a_large_photo_decodes_as_pillow_does():
    img = seeded(1203, 1611, 3)
    for kw in ({"quality": 92, "subsampling": 2}, {"quality": 70, "subsampling": 1,
                                                    "progressive": True}):
        data = pillow_jpeg(img, **kw)
        assert np.array_equal(decode_jpeg(data), pillow_rgb(data))


# -- what the decoder refuses ---------------------------------------------------------

def _sof_at(data: bytes) -> int:
    for marker in (b"\xff\xc0", b"\xff\xc1", b"\xff\xc2"):
        i = data.find(marker)
        if i >= 0:
            return i
    raise AssertionError("no SOF")


@pytest.mark.parametrize("decoder", ["native", "plain"])
def test_refused_jpegs_are_named(decoder):
    dec = decode_jpeg if decoder == "native" else decode_jpeg_plain
    if decoder == "native" and not tnative.native_available(tnative.IMAGE_SRC):
        pytest.skip("no C++ compiler")
    img = seeded(24, 24, 1)
    base = pillow_jpeg(img, quality=80)
    i = _sof_at(base)

    def relabel(code: int) -> bytes:
        return base[:i + 1] + bytes([code]) + base[i + 2:]

    cases = {
        "arithmetic": relabel(0xC9),
        "lossless": relabel(0xC3),
        "hierarchical": relabel(0xC5),
        "12-bit": base[:i + 4] + bytes([12]) + base[i + 5:],
        "DNL": base[:i + 5] + b"\0\0" + base[i + 7:],
    }
    cmyk = io.BytesIO()
    Image.new("CMYK", (8, 8)).save(cmyk, "JPEG")
    cases["CMYK"] = cmyk.getvalue()
    prog = pillow_jpeg(img, progressive=True)
    # keep only the first two scans: coefficients 1..9 stay incomplete, which
    # libjpeg would block-smooth
    sos = [k for k in range(len(prog)) if prog[k:k + 2] == b"\xff\xda"]
    cases["incomplete"] = prog[:sos[2]] + b"\xff\xd9"
    for name, data in cases.items():
        with pytest.raises(JPEGUnsupported, match=name) as info:
            dec(data)
        assert "unsupported JPEG" in str(info.value), name
        assert isinstance(info.value, ValueError)


CHILD_PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
{setup}
from distributed_gpu_inference_torch import native
from distributed_gpu_inference_torch.utils.jpeg import (
    JPEGUnsupported, decode_jpeg, decode_jpeg_plain)
decoders = {{"native": decode_jpeg, "plain": decode_jpeg_plain}}
said = {{}}
for name, (path, names) in json.load(open({plan!r})).items():
    data = open(path, "rb").read()
    for dn in names:
        try:
            out = decoders[dn](data)
            assert out.dtype.name == "uint8" and out.ndim == 3 and out.shape[2] == 3
            said[name + " / " + dn] = "decoded"
        except JPEGUnsupported as exc:
            said[name + " / " + dn] = str(exc)
# VmHWM, not ru_maxrss: Linux carries ru_maxrss over from the forked parent
hwm = [line.split()[1] for line in open("/proc/self/status") if line.startswith("VmHWM:")]
print(json.dumps({{"said": said, "plain_taken": native.PLAIN_TAKEN, "peak_rss_kib": int(hwm[0])}}))
"""


def decode_in_child(tmp_path, cases, plain_every=1, setup="", env=None):
    """Each case through the native decoder, and every ``plain_every``-th
    through the plain one, in a child process, so that a crash fails the
    test instead of the run → ``{"said": {"<case> / <decoder>": "decoded"
    or the message}, "plain_taken": ..., "peak_rss_kib": ...}``."""
    plan = {}
    for i, (name, data) in enumerate(cases.items()):
        path = tmp_path / f"case{i}.jpg"
        path.write_bytes(data)
        plain = bool(plain_every) and i % plain_every == 0
        plan[name] = (str(path), ["native"] + (["plain"] if plain else []))
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    probe = CHILD_PROBE.format(root=str(ROOT), setup=setup, plan=str(tmp_path / "plan.json"))
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def corruption_cases(data: bytes, tag: str):
    """About 150 truncations, 250 copies with 1-3 bytes replaced at random
    (seed 0), and random bytes after an SOI."""
    rng = np.random.default_rng(0)
    cases = {f"{tag} cut at {n}": data[:n]
             for n in range(0, len(data) - 1, max(1, len(data) // 150))}
    cases[f"{tag} cut before EOI"] = data[:-2]
    for i in range(250):
        b = bytearray(data)
        for p in rng.integers(2, len(b), size=int(rng.integers(1, 4))):
            b[p] = int(rng.integers(0, 256))
        cases[f"{tag} flip {i}"] = bytes(b)
    cases[f"{tag} noise"] = b"\xff\xd8" + bytes(rng.integers(0, 256, 400, dtype=np.uint8))
    return cases


def corrupt_photo(kind: str) -> bytes:
    return pillow_jpeg(seeded(40, 56, 2), quality=85, subsampling=2,
                       progressive=kind == "progressive", restart_marker_blocks=4)


@needs_cxx
@pytest.mark.parametrize("kind", ["baseline", "progressive"])
def test_truncated_and_corrupt_files_raise_and_never_crash(tmp_path, kind):
    data = corrupt_photo(kind)
    # every truncation raises, in both decoders
    for n in list(range(0, len(data) - 1, 7)) + [len(data) - 2, len(data) - 1]:
        for dec in (decode_jpeg, decode_jpeg_plain):
            with pytest.raises(JPEGUnsupported):
                dec(data[:n])
    for bad in (b"", b"\xff\xd8", b"GIF89a", b"\xff\xd8\xff\xd9", data[:2] + data[200:]):
        with pytest.raises(JPEGUnsupported):
            decode_jpeg(bad)
    # random bytes flipped anywhere: raise JPEGUnsupported or decode
    got = decode_in_child(tmp_path, corruption_cases(data, kind), plain_every=5)
    assert got["plain_taken"] == {}
    assert sum(v != "decoded" for v in got["said"].values()) > 0


def bogus_huffman_cases():
    """DHT segments whose code lengths break the Kraft inequality: table 0
    of each class redefined with 3 or 255 one-bit codes, before the first
    SOS of a baseline file and between the scans of a progressive one."""
    img = seeded(24, 40, 6)
    base = pillow_jpeg(img, quality=80)
    prog = pillow_jpeg(img, quality=80, progressive=True)
    first = base.index(b"\xff\xda")
    third = [k for k in range(len(prog)) if prog[k:k + 2] == b"\xff\xda"][2]
    cases = {}
    for cls, tc in (("DC", 0), ("AC", 1)):
        for n in (3, 255):
            seg = _segment(0xC4, bytes([tc << 4, n] + [0] * 15) + bytes(range(n)))
            cases[f"{cls} counts[0] = {n} before the first SOS"] = \
                base[:first] + seg + base[first:]
            cases[f"{cls} counts[0] = {n} between progressive scans"] = \
                prog[:third] + seg + prog[third:]
    return cases


@needs_cxx
def test_huffman_tables_that_break_the_kraft_inequality_are_refused(tmp_path):
    got = decode_in_child(tmp_path, bogus_huffman_cases())
    assert len(got["said"]) == 16 and got["plain_taken"] == {}
    for case, said in got["said"].items():
        assert said == "corrupt JPEG: bogus Huffman table", case


def huge_header_cases(kind: str):
    """A 16 x 16 4:4:4 file relabelled 13,000 x 13,000 (about 1 GB of
    coefficients), with no entropy data, and with one kilobyte."""
    data = pillow_jpeg(seeded(16, 16, 7), quality=80, subsampling=0,
                       progressive=kind == "progressive")
    i = _sof_at(data)
    huge = data[:i + 5] + struct.pack(">HH", 13000, 13000) + data[i + 9:]
    sos = huge.index(b"\xff\xda")
    head = huge[:sos + 2 + struct.unpack(">H", huge[sos + 2:sos + 4])[0]]
    return {f"{kind} 13000x13000 header only": head + b"\xff\xd9",
            f"{kind} 13000x13000 with 1 KB of entropy data": head + bytes(1024) + b"\xff\xd9"}


@needs_cxx
@pytest.mark.parametrize("kind", ["baseline", "progressive"])
def test_a_header_declaring_a_huge_image_is_refused_before_its_buffers(tmp_path, kind):
    got = decode_in_child(tmp_path, huge_header_cases(kind))
    assert len(got["said"]) == 4 and got["plain_taken"] == {}
    for case, said in got["said"].items():
        assert said == ("corrupt JPEG: truncated file: too little entropy data for the image "
                        "size"), case
    # the child never held the image's buffers (about 1.5 GB with the output)
    assert got["peak_rss_kib"] < 400 * 1024, got["peak_rss_kib"]


def test_a_scan_after_a_scan_of_every_component_is_refused_as_pillow_refuses_it():
    data = pillow_jpeg(seeded(16, 24, 8), quality=80)
    twice = data[:-2] + data[data.index(b"\xff\xda"):]
    with pytest.raises(OSError):
        pillow_rgb(twice)
    for dec in (decode_jpeg, decode_jpeg_plain):
        with pytest.raises(JPEGUnsupported, match="a second scan after a scan of every"):
            dec(twice)


def _asan_runtime():
    """What a child that loads an AddressSanitizer build must preload: the
    runtime of ``$CXX``, and the C++ library, whose ``__cxa_throw`` the
    runtime intercepts (Python links none); None where either is missing."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    libs = []
    for name in ("libasan.so", "libstdc++.so"):
        try:
            out = subprocess.run([cxx, f"-print-file-name={name}"], capture_output=True,
                                 text=True, timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            return None
        if not (os.path.isabs(out) and os.path.exists(out)):
            return None
        libs.append(out)
    return " ".join(libs)


ASAN_FLAGS = ("-fsanitize=address", "-fno-omit-frame-pointer")
ASAN_SETUP = """
from pathlib import Path
from distributed_gpu_inference_torch import native
native.BUILD_DIR = Path({build!r})
native.CXX_FLAGS = native.CXX_FLAGS + {flags!r}
"""


@pytest.mark.skipif(_asan_runtime() is None, reason="no AddressSanitizer runtime for $CXX")
def test_corrupt_files_under_address_sanitizer(tmp_path, monkeypatch):
    """The corruption probes, the bogus Huffman tables and the huge headers
    once more against a ``-fsanitize=address`` build of the codec: a read
    or write out of bounds anywhere ends the child with an error."""
    build = tmp_path / "asan"
    monkeypatch.setattr(tnative, "BUILD_DIR", build)
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ASAN_FLAGS)
    # built here, so that the compiler does not run under the preloaded runtime
    assert tnative._compile(tnative.IMAGE_SRC, tnative.library_path(tnative.IMAGE_SRC))
    cases = {**corruption_cases(corrupt_photo("baseline"), "baseline"),
             **corruption_cases(corrupt_photo("progressive"), "progressive"),
             **bogus_huffman_cases(), **huge_header_cases("baseline"),
             **huge_header_cases("progressive")}
    env = dict(os.environ, LD_PRELOAD=_asan_runtime(), ASAN_OPTIONS="detect_leaks=0")
    got = decode_in_child(tmp_path, cases, plain_every=0, env=env,
                          setup=ASAN_SETUP.format(build=str(build), flags=ASAN_FLAGS))
    assert got["plain_taken"] == {} and len(got["said"]) == len(cases)
    assert [p.name for p in build.iterdir()] == [tnative.library_path(tnative.IMAGE_SRC).name]


# -- the resize ------------------------------------------------------------------------

RESIZE_SIDES = [1, 2, 3, 5, 8, 31, 32, 33, 100, 223, 224, 225, 301]


@pytest.mark.parametrize("h", RESIZE_SIDES)
def test_resize_matches_pillow(h):
    rng = np.random.default_rng(h)
    for w in (1, 4, 33, 224, 257):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for size in ((224, 224), (32, 32), (1, 1), (w, 224), (224, h), (7, 300)):
            ref = np.asarray(Image.fromarray(img).resize(size))
            assert np.array_equal(resize_bicubic_plain(img, size), ref), (h, w, size)
            if tnative.native_available(tnative.IMAGE_SRC):
                assert np.array_equal(resize_bicubic(img, size), ref), (h, w, size)


@needs_cxx
@pytest.mark.parametrize("shape", [(3024, 4032), (1080, 1920), (667, 1001), (2, 4032)])
def test_resize_of_photo_sizes_matches_pillow(shape):
    img = seeded(*shape, seed=shape[1])
    for size in ((224, 224), (32, 32)):
        assert np.array_equal(resize_bicubic(img, size),
                              np.asarray(Image.fromarray(img).resize(size)))
    small = img[: min(shape[0], 300), :300]
    assert np.array_equal(resize_bicubic(small, (224, 224)),
                          resize_bicubic_plain(small, (224, 224)))


def test_resize_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match=r"\[H, W, 3\] uint8"):
        resize_bicubic(np.zeros((4, 4), np.uint8), (2, 2))
    with pytest.raises(ValueError, match="at least 1"):
        resize_bicubic(np.zeros((4, 4, 3), np.uint8), (0, 2))


# -- PNG -------------------------------------------------------------------------------

PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
             (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("ctype,depth", PNG_KINDS, ids=lambda v: str(v))
@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("unfilter", ["native", "plain"])
def test_png_of_every_kind_reads_as_pillow_does(ctype, depth, interlace, unfilter, monkeypatch):
    if unfilter == "plain":
        monkeypatch.setattr(tnative, "_load", lambda src=None: None)
        monkeypatch.setattr(tnative, "PLAIN_TAKEN", {})
    elif not tnative.native_available(tnative.IMAGE_SRC):
        pytest.skip("no C++ compiler")
    rng = np.random.default_rng(ctype * 100 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for h, w in ((1, 1), (3, 2), (9, 13), (17, 8), (24, 33)):
        samples = rng.integers(0, 1 << depth, (h, w, ch), dtype=np.int64)
        samples = samples.astype(np.uint16 if depth == 16 else np.uint8)
        palette = bytes(rng.integers(0, 256, 3 * (1 << depth), dtype=np.uint8)) \
            if ctype == 3 else b""
        data = mif.write_png(samples, depth, ctype, interlace, palette)
        assert np.array_equal(decode_png(data), pillow_rgb(data)), (h, w)
    assert bool(tnative.PLAIN_TAKEN) == (unfilter == "plain")


def test_pngs_pillow_writes_read_as_pillow_does():
    img = seeded(37, 51, 8)
    for mode in ("RGB", "RGBA", "L", "LA", "P", "1", "I;16"):
        im = Image.fromarray(img).convert(mode if mode != "I;16" else "L")
        if mode == "I;16":
            im = Image.fromarray((img[..., 0].astype(np.uint16) * 300))
        buf = io.BytesIO()
        im.save(buf, "PNG", optimize=True)
        assert np.array_equal(decode_png(buf.getvalue()), pillow_rgb(buf.getvalue())), mode
    # tRNS is ignored, as convert("RGB") drops alpha
    im = Image.fromarray(img).convert("P")
    buf = io.BytesIO()
    im.save(buf, "PNG", transparency=3)
    assert b"tRNS" in buf.getvalue()
    assert np.array_equal(decode_png(buf.getvalue()), pillow_rgb(buf.getvalue()))


def test_corrupt_pngs_raise():
    good = mif.write_png(seeded(9, 9, 1), 8, 2, 1)
    with pytest.raises(PNGUnsupported, match="not a PNG"):
        decode_png(b"GIF89a")
    with pytest.raises(PNGUnsupported, match="CRC"):
        decode_png(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(PNGUnsupported):
        decode_png(good[:-20])
    ihdr = struct.pack(">IIBBBBB", 4, 4, 16, 3, 0, 0, 0)       # 16-bit palette: invalid
    with pytest.raises(PNGUnsupported, match="bit depth 16, colour type 3"):
        decode_png(tpng.SIGNATURE + tpng._chunk(b"IHDR", ihdr) + tpng._chunk(b"IEND", b""))
    import zlib

    bad_filter = tpng.SIGNATURE + tpng._chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 1, 8, 0, 0, 0,
                                                                   0))
    bad_filter += tpng._chunk(b"IDAT", zlib.compress(b"\x07\x01\x02")) + tpng._chunk(b"IEND", b"")
    with pytest.raises(PNGUnsupported, match="row filter"):
        decode_png(bad_filter)
    # a zlib bomb: 64 MB of zeros behind a 1x1 header stops one byte past
    # what the header needs; a size past Pillow's limit is refused unread
    bomb = tpng.SIGNATURE + tpng._chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 0, 0, 0, 0))
    bomb += tpng._chunk(b"IDAT", zlib.compress(bytes(64 << 20), 9)) + tpng._chunk(b"IEND", b"")
    assert len(bomb) < 200_000
    with pytest.raises(PNGUnsupported, match=r"holds 3\+ bytes, expected 2"):
        decode_png(bomb)
    huge = tpng.SIGNATURE + tpng._chunk(b"IHDR", struct.pack(">IIBBBBB", 20000, 20000, 8, 2,
                                                              0, 0, 0))
    with pytest.raises(PNGUnsupported, match="more than Pillow opens"):
        decode_png(huge + tpng._chunk(b"IEND", b""))


# -- the fixtures ----------------------------------------------------------------------

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())


def test_the_fixture_script_reproduces_the_committed_set():
    files = mif.build(MANIFEST["seed"])
    assert mif.manifest(files, MANIFEST["seed"]) == MANIFEST
    for name, data in files.items():
        assert (FIXTURES / name).read_bytes() == data, name
    assert sum(len(b) for b in files.values()) < 5_000_000
    kinds = {e["file"]: (e["width"], e["height"]) for e in MANIFEST["images"]}
    assert kinds["photo_4032x3024_420_q85.jpg"] == (4032, 3024)
    assert len(kinds) == 7


@needs_cxx
@pytest.mark.parametrize("entry", MANIFEST["images"], ids=lambda e: e["file"])
def test_each_fixture_decodes_and_resizes_to_pillows_digests(entry):
    data = (FIXTURES / entry["file"]).read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["file_sha256"]
    rgb = decode_jpeg(data) if is_jpeg(data) else decode_png(data)
    assert rgb.shape == (entry["height"], entry["width"], 3)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == entry["decoded_sha256"]
    small = resize_bicubic(rgb, (224, 224))
    assert hashlib.sha256(small.tobytes()).hexdigest() == entry["resized_224_sha256"]


@needs_cxx
def test_native_and_plain_agree_on_the_smallest_fixtures():
    grey = (FIXTURES / "grey_640x480.jpg").read_bytes()
    assert np.array_equal(decode_jpeg(grey), decode_jpeg_plain(grey))
    png16 = (FIXTURES / "rgb16_320x240.png").read_bytes()
    rgb = decode_png(png16)
    assert np.array_equal(resize_bicubic(rgb, (224, 224)), resize_bicubic_plain(rgb, (224, 224)))


# -- without a compiler ----------------------------------------------------------------

def test_without_a_compiler_each_plain_version_is_taken_with_a_warning(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", False)
    monkeypatch.setattr(tnative, "PLAIN_TAKEN", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    img = seeded(20, 30, 4)
    jpeg = pillow_jpeg(img, quality=90)
    png = mif.write_png(img, 8, 2, 1)
    with caplog.at_level(logging.WARNING, logger="torch_native"):
        assert np.array_equal(decode_jpeg(jpeg), pillow_rgb(jpeg))
        assert np.array_equal(resize_bicubic(img, (7, 9)),
                              np.asarray(Image.fromarray(img).resize((7, 9))))
        assert np.array_equal(decode_png(png), pillow_rgb(png))
        decode_jpeg(jpeg)
    assert tnative.PLAIN_TAKEN == {"decode_jpeg": 2, "resize_bicubic": 1, "png_unfilter": 7}
    said = [r.getMessage() for r in caplog.records]
    for plain in ("decode_jpeg_plain", "resize_bicubic_plain", "utils.png._unfilter"):
        assert sum(plain in m for m in said) == 1, said
