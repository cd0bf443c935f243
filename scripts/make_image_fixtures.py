#!/usr/bin/env python3
"""Write the image fixtures of the port's vision path, and Pillow's answers.

    python scripts/make_image_fixtures.py [--seed 0] [--out tests/fixtures/images]
    python scripts/make_image_fixtures.py --check     # rebuild in memory, compare

Images are synthesised with numpy from ``--seed`` (gradients, sinusoids,
hard edges, thin strokes like text, mild noise) and written with Pillow;
Pillow writes no interlaced and no 16-bit RGB PNG, so those two go
through :func:`write_png` here, a small writer on ``zlib``. The manifest,
``manifest.json`` beside them, holds for each file the SHA-256 of its
bytes, of Pillow's ``np.asarray(Image.open(f).convert("RGB"))`` and of
Pillow's ``Image.fromarray(that).resize((224, 224))``, so a machine
without Pillow can hold its decoder and resize to Pillow's. Needs Pillow
(12.1.0 wrote the committed set); ``--check`` exits 1 if the set or the
manifest would change.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "fixtures" / "images"
RESIZE = 224

# name → (width, height, how it is written)
FIXTURES: Dict[str, Tuple[int, int, dict]] = {
    "photo_4032x3024_420_q85.jpg":
        (4032, 3024, {"format": "JPEG", "quality": 85, "subsampling": 2, "noise": 6.0}),
    "photo_1920x1080_progressive_420.jpg":
        (1920, 1080, {"format": "JPEG", "quality": 85, "subsampling": 2,
                      "progressive": True, "optimize": True}),
    "photo_1000x750_444_rst64.jpg":
        (1000, 750, {"format": "JPEG", "quality": 90, "subsampling": 0,
                     "restart_marker_blocks": 64}),
    "photo_1001x667_422.jpg":
        (1001, 667, {"format": "JPEG", "quality": 80, "subsampling": 1}),
    "grey_640x480.jpg": (640, 480, {"format": "JPEG", "quality": 75, "mode": "L"}),
    "adam7_rgba_800x600.png": (800, 600, {"format": "PNG", "ctype": 6, "depth": 8,
                                          "interlace": 1, "noise": 1.0}),
    "rgb16_320x240.png": (320, 240, {"format": "PNG", "ctype": 2, "depth": 16,
                                     "interlace": 0, "noise": 1.0}),
}


def synth(h: int, w: int, seed: int, channels: int = 3, noise: float = 2.0) -> np.ndarray:
    """A photo-like float image in [0, 255]: smooth gradients and
    sinusoids, hard-edged shapes, thin dark strokes like a line of text,
    and mild noise."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float64)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float64)[None, :]
    img = np.empty((h, w, channels))
    for c in range(channels):
        fx, fy, ph = rng.uniform(2, 9), rng.uniform(2, 9), rng.uniform(0, 6.28)
        img[..., c] = (60 + 120 * (x * rng.uniform(0.3, 1) + y * rng.uniform(0.3, 1)) / 2
                       + 50 * np.sin(2 * np.pi * fx * x + ph) * np.cos(2 * np.pi * fy * y))
    for _ in range(6):      # hard-edged rectangles and discs
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(0.04, 0.2) * h, rng.uniform(0.04, 0.2) * w
        colour = rng.uniform(0, 255, channels)
        if rng.random() < 0.5:
            mask = (np.abs(y * h - cy) < ry) & (np.abs(x * w - cx) < rx)
        else:
            mask = ((y * h - cy) / ry) ** 2 + ((x * w - cx) / rx) ** 2 < 1
        img[mask] = colour
    # a paragraph of strokes: rows of short dark dashes, 1-3 px thick
    line_h = max(4, h // 40)
    top = int(h * 0.6)
    for row in range(6):
        y0 = top + row * 2 * line_h
        if y0 + 3 >= h:
            break
        xpos = int(w * 0.1)
        while xpos < int(w * 0.9):
            length = int(rng.integers(2, max(3, w // 60)))
            thick = int(rng.integers(1, 4))
            img[y0:y0 + thick, xpos:xpos + length] = 20
            img[y0 - line_h // 2:y0 + line_h // 2, xpos:xpos + 1] = 20   # a vertical stroke
            xpos += length + int(rng.integers(1, max(2, w // 120)))
    img += rng.normal(0.0, noise, img.shape)
    return np.clip(img, 0, 255)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _filter_rows(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Each row filtered with type (first + row) % 5, so every filter runs."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for i, row in enumerate(rows.astype(np.int64)):
        f = (first + i) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(f)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def write_png(samples: np.ndarray, depth: int, ctype: int, interlace: int = 0,
              palette: bytes = b"") -> bytes:
    """``samples`` [H, W, channels] (uint8, or uint16 at depth 16) → the
    bytes of a PNG, any colour type and depth, Adam7 when ``interlace``."""
    h, w, ch = samples.shape
    bits = ch * depth
    bpp = max(1, bits // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = bytearray()
    for i, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        ph, pw = sub.shape[:2]
        if depth == 16:
            rows = sub.astype(">u2").reshape(ph, pw * ch).view(np.uint8)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(ph, pw * ch)
        else:
            vals = sub.reshape(ph, pw).astype(np.uint8)
            unpacked = np.unpackbits(vals[..., None], axis=2)[..., 8 - depth:]
            rows = np.packbits(unpacked.reshape(ph, pw * depth), axis=1)
        raw += _filter_rows(rows, bpp, i)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    body = _chunk(b"IHDR", ihdr)
    if palette:
        body += _chunk(b"PLTE", palette)
    return (b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IDAT", zlib.compress(bytes(raw), 9))
            + _chunk(b"IEND", b""))


def build(seed: int) -> Dict[str, bytes]:
    """The fixture files, by name, made from ``seed``."""
    from PIL import Image

    files: Dict[str, bytes] = {}
    for i, (name, (w, h, how)) in enumerate(FIXTURES.items()):
        how = dict(how)
        fmt = how.pop("format")
        noise = how.pop("noise", 2.0)
        if fmt == "JPEG":
            mode = how.pop("mode", "RGB")
            img = synth(h, w, seed * 100 + i, 1 if mode == "L" else 3, noise).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img[..., 0] if mode == "L" else img).save(buf, "JPEG", **how)
            files[name] = buf.getvalue()
        else:
            ch = {2: 3, 6: 4}[how["ctype"]]
            img = synth(h, w, seed * 100 + i, ch, noise)
            if how["depth"] == 16:
                img = (img * 257.0).astype(np.uint16)
            files[name] = write_png(img.astype(np.uint16 if how["depth"] == 16 else np.uint8),
                                    how["depth"], how["ctype"], how["interlace"])
    return files


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def manifest(files: Dict[str, bytes], seed: int) -> dict:
    """Pillow's answers for each file."""
    import PIL
    from PIL import Image, features

    entries: List[dict] = []
    for name, data in files.items():
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        small = np.asarray(Image.fromarray(rgb).resize((RESIZE, RESIZE)))
        entries.append({"file": name, "width": int(rgb.shape[1]), "height": int(rgb.shape[0]),
                        "bytes": len(data), "file_sha256": sha256(data),
                        "decoded_sha256": sha256(np.ascontiguousarray(rgb).tobytes()),
                        f"resized_{RESIZE}_sha256": sha256(small.tobytes())})
    return {"seed": seed, "pillow": PIL.__version__,
            "libjpeg_turbo": features.version("libjpeg_turbo"), "resize": RESIZE,
            "images": entries}


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--check", action="store_true",
                    help="rebuild in memory and compare with the files in --out")
    args = ap.parse_args(argv)
    files = build(args.seed)
    man = manifest(files, args.seed)
    if args.check:
        old = json.loads((args.out / "manifest.json").read_text())
        same = old == man and all((args.out / n).read_bytes() == b for n, b in files.items())
        print("fixtures reproduced" if same else "fixtures differ")
        return 0 if same else 1
    args.out.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        (args.out / name).write_bytes(data)
    (args.out / "manifest.json").write_text(json.dumps(man, indent=1) + "\n")
    total = sum(len(b) for b in files.values())
    print(f"wrote {len(files)} images, {total} bytes, to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
