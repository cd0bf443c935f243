#!/usr/bin/env python3
"""Write the zstd frames and the worker-config files the port is held to.

    python scripts/make_zstd_fixtures.py [--seed 0]
    python scripts/make_zstd_fixtures.py --check     # rebuild in memory, compare

``tests/fixtures/zstd/``: frames written by ``zstandard`` (libzstd) from
payloads made with numpy from ``--seed``: one payload at levels -5, 1, 3, 9
and 19; a frame with a checksum and one without; a multi-block frame past
128 KiB; a bf16 KV page, an f32 logits row, an all-zero page and an
incompressible int8 page as the JAX ``TensorSerializer`` compresses them
(level 3); two frames back to back (a reader takes the first); an RLE
block and a raw block past the block maximum, built by hand, which
libzstd's one-shot decoder reads; and the frames a reader must refuse: one
without a content size, one made with a dictionary, a skippable frame, a
truncated frame, two with a flipped bit, and a compressed block that
restores past the block maximum, built by hand. ``manifest.json`` holds, for each file, its SHA-256 and either the
size and SHA-256 of what ``zstandard.ZstdDecompressor().decompress``
returns or the reason it refuses the file.

``tests/fixtures/config/``: a worker config as the JAX worker writes it
back after registering (``utils/config.py`` ``save_worker_config``,
``yaml.safe_dump(..., sort_keys=False)``) and its JSON twin (the same
``model_dump(mode="json")``).

Needs ``zstandard`` (0.25.0, libzstd 1.5.7 wrote the committed set), PyYAML
and the JAX package's config module; ``--check`` exits 1 if a file or the
manifest would change.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ZSTD_OUT = ROOT / "tests" / "fixtures" / "zstd"
CONFIG_OUT = ROOT / "tests" / "fixtures" / "config"


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _payloads(seed: int) -> Dict[str, bytes]:
    rng = np.random.default_rng(seed)
    words = [b"worker", b"region", b"eu-west", b"llama3-8b", b"prefill", b"decode",
             b"kv_cache", b"0.25", b"true", b"null", b"\n", b": ", b"  - "]
    text = b"".join(words[i] for i in rng.integers(0, len(words), 9000))
    numbers = rng.integers(0, 1000, 4000).astype(np.int32).tobytes()
    bf16 = (rng.standard_normal((2, 2, 8, 16, 64)).astype(np.float32).view(np.uint32)
            >> 16).astype(np.uint16).tobytes()
    return {
        "mixed": text[:30000] + numbers,
        "big": (text + numbers) * 4 + rng.integers(0, 4, 60000).astype(np.uint8).tobytes(),
        "bf16_page": bf16,
        "f32_logits": (rng.standard_normal(32000) * 3).astype(np.float32).tobytes(),
        "zero_page": bytes(65536),
        "int8_uniform": rng.integers(-128, 128, 65536).astype(np.int8).tobytes(),
    }


def _flip_refused(frame: bytes, lo: int, hi: int, rng: np.random.Generator, zstd) -> bytes:
    """``frame`` with one bit in ``[lo, hi)`` flipped, where ``zstandard``
    refuses the result."""
    for _ in range(10000):
        at = int(rng.integers(lo, hi))
        bad = bytearray(frame)
        bad[at] ^= 1 << int(rng.integers(0, 8))
        try:
            zstd.ZstdDecompressor().decompress(bytes(bad))
        except zstd.ZstdError:
            return bytes(bad)
    raise RuntimeError("no refused bit flip found")


def _block(last: int, kind: int, size: int, body: bytes) -> bytes:
    return (last | kind << 1 | size << 3).to_bytes(3, "little") + body


def _hand_built() -> Dict[str, bytes]:
    """Frames no encoder writes, at the block maximum (min(window, 128 KiB)):
    a 200 KiB RLE block and a 2 KiB raw block in a 1 KiB window, which
    libzstd's one-shot decoder reads, and a compressed block in a 1 KiB
    window whose one match restores 2,047 bytes, which it refuses."""
    magic = (0xFD2FB528).to_bytes(4, "little")
    n = 200 * 1024
    rle = magic + bytes([0xA0]) + n.to_bytes(4, "little") + _block(1, 1, n, b"\x5a")
    # not single-segment, window descriptor 0 (1 KiB), a 2-byte content size
    small = magic + bytes([0x40, 0]) + (2048 - 256).to_bytes(2, "little")
    raw = small + _block(1, 0, 2048, bytes(range(256)) * 8)
    # no literals; one sequence in RLE modes: literal length code 0, offset
    # code 2 (offset 1, its 2 extra bits 0), match length code 46 (1,027 +
    # 10 bits of 1,020), then the stream's end mark
    seqs = bytes([0, 1, 0x54, 0, 2, 46]) + (1020 | 1 << 12).to_bytes(2, "little")
    match = small + _block(0, 0, 1, b"a") + _block(1, 2, len(seqs), seqs)
    return {"rle_past_block_max.zst": rle, "raw_past_window.zst": raw,
            "match_past_window.zst": match}


def build_zstd(seed: int) -> Tuple[Dict[str, bytes], Dict[str, str]]:
    """The frames, and the refusal each refused one is for."""
    import zstandard as zstd

    p = _payloads(seed)
    rng = np.random.default_rng(seed + 1)
    c3 = zstd.ZstdCompressor(level=3)
    files: Dict[str, bytes] = {}
    for level in (-5, 1, 3, 9, 19):
        files[f"level_{level}.zst".replace("-", "m")] = \
            zstd.ZstdCompressor(level=level).compress(p["mixed"])
    files["checksum.zst"] = zstd.ZstdCompressor(level=3, write_checksum=True).compress(p["mixed"])
    files["no_checksum.zst"] = c3.compress(p["mixed"][:20000])
    files["multiblock.zst"] = zstd.ZstdCompressor(level=3, write_checksum=True).compress(p["big"])
    for name in ("bf16_page", "f32_logits", "zero_page", "int8_uniform"):
        files[f"{name}.zst"] = c3.compress(p[name])
    files["concatenated.zst"] = c3.compress(p["mixed"][:5000]) + c3.compress(p["mixed"][5000:9000])
    files.update(_hand_built())
    refused = {
        "match_past_window.zst": "block past its maximum",
        "no_content_size.zst": "no content size",
        "dictionary.zst": "dictionary",
        "skippable.zst": "skippable",
        "truncated.zst": "truncated",
        "bitflip_literals.zst": "corrupt",
        "bitflip_sequences.zst": "corrupt",
    }
    files["no_content_size.zst"] = zstd.ZstdCompressor(
        level=3, write_content_size=False).compress(p["mixed"][:8000])
    samples = [p["mixed"][i:i + 300] for i in range(0, 30000, 150)]
    zdict = zstd.train_dictionary(2048, samples, k=64, d=8, threads=0)
    files["dictionary.zst"] = zstd.ZstdCompressor(
        level=3, dict_data=zdict).compress(p["mixed"][:4000])
    files["skippable.zst"] = (0x184D2A5A).to_bytes(4, "little") + (16).to_bytes(4, "little") \
        + bytes(range(16)) + c3.compress(p["mixed"][:1000])
    whole = files["checksum.zst"]
    files["truncated.zst"] = whole[:len(whole) * 2 // 3]
    # a flip in a checksummed frame's first half (its first block's
    # literals) and in its last third
    files["bitflip_literals.zst"] = _flip_refused(whole, 12, len(whole) // 2, rng, zstd)
    files["bitflip_sequences.zst"] = _flip_refused(whole, len(whole) * 2 // 3,
                                                   len(whole) - 4, rng, zstd)
    return files, refused


def zstd_manifest(files: Dict[str, bytes], refused: Dict[str, str], seed: int) -> dict:
    import zstandard as zstd

    entries: List[dict] = []
    for name, frame in files.items():
        entry = {"file": name, "bytes": len(frame), "file_sha256": _sha(frame)}
        try:
            content = zstd.ZstdDecompressor().decompress(frame)
        except zstd.ZstdError as exc:
            if name not in refused:
                raise RuntimeError(f"{name}: zstandard refuses it: {exc}") from None
            entry.update(refused=refused[name], zstandard_error=str(exc))
        else:
            if name in refused:
                raise RuntimeError(f"{name}: zstandard reads it")
            entry.update(content_bytes=len(content), content_sha256=_sha(content))
        entries.append(entry)
    return {"seed": seed, "zstandard": zstd.__version__,
            "libzstd": ".".join(map(str, zstd.ZSTD_VERSION)), "frames": entries}


def build_config() -> Dict[str, bytes]:
    """The JAX worker's ``config.yaml`` after registration, and its JSON
    twin."""
    import tempfile

    from distributed_gpu_inference_tpu.utils import config as jc

    env = {
        "TPU_WORKER_NAME": "edge-worker-7",
        "TPU_WORKER_REGION": "eu-west",
        "TPU_WORKER_TASK_TYPES": '["llm"]',
        "TPU_WORKER_SERVER__URL": "http://control-plane.internal:8000",
        "TPU_WORKER_LOAD_CONTROL__WORKING_HOURS": "[9, 17]",
        "TPU_WORKER_LOAD_CONTROL__ACCEPTANCE_RATE": "0.8",
        "TPU_WORKER_DIRECT__ENABLED": "true",
        "TPU_WORKER_DIRECT__PORT": "9001",
        "TPU_WORKER_DIRECT__PUBLIC_URL": "http://edge7:9001",
        "TPU_WORKER_ENGINES": json.dumps({"llm": {
            "model": "llama3-8b", "quantization": "int8",
            "extra": {"note": "a long free-text note that the emitter folds at eighty "
                              "columns, with: colons, # hashes and 'quotes'",
                      "flags": ["yes", "0x1F", "1e5", "", "~"], "ratio": 1e-05}}}),
    }
    cfg = jc.load_worker_config(environ=env)
    cfg.server.worker_id = "w-3f9c2a71"
    cfg.server.auth_token = "tok_-8Zx:q'Lm#2"
    cfg.server.api_key = "0123"
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "config.yaml"
        jc.save_worker_config(cfg, path)
        yaml_bytes = path.read_bytes()
    twin = json.dumps(cfg.model_dump(mode="json"), indent=2) + "\n"
    return {"config.yaml": yaml_bytes, "config.json": twin.encode()}


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="rebuild in memory and compare with the committed files")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    frames, refused = build_zstd(args.seed)
    man = json.dumps(zstd_manifest(frames, refused, args.seed), indent=1) + "\n"
    outputs = {ZSTD_OUT / n: b for n, b in frames.items()}
    outputs[ZSTD_OUT / "manifest.json"] = man.encode()
    outputs.update({CONFIG_OUT / n: b for n, b in build_config().items()})
    if args.check:
        same = all(p.is_file() and p.read_bytes() == b for p, b in outputs.items())
        print("fixtures reproduced" if same else "fixtures differ")
        return 0 if same else 1
    for path, data in outputs.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    print(f"wrote {len(outputs)} files, {sum(map(len, outputs.values()))} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
