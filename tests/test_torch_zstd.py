"""The port's zstd codec (``utils/zstd.py`` over ``native/src/zstd_codec.cpp``)
against ``zstandard`` (CPU).

- Decoding: the native decoder and the plain one return
  ``zstandard.ZstdDecompressor().decompress``'s bytes on every committed
  fixture (``tests/fixtures/zstd``, written by ``scripts/make_zstd_fixtures.py``
  with libzstd 1.5.7) and on hypothesis payloads at levels -5 to 19, with
  and without a checksum; they refuse what it refuses (no content size, a
  dictionary, a skippable frame, truncation, corruption, a compressed block
  restoring past the block maximum), read raw and RLE blocks past it as it
  does, and read the first frame only.
- Encoding: the port's frames decode through ``zstandard`` and both port
  decoders to the input, and on bf16, f32 and int8 tensor payloads are
  within 2% of libzstd level 3's size; an all-zero page of 64 KiB or more
  is under 1% of raw.
- Corrupt input (truncations and flipped bits of frames from both
  encoders) is decoded in a child process, once more against a
  ``-fsanitize=address`` build: a crash or an out-of-bounds access fails
  the test; a frame ``zstandard`` refuses is refused, and what the port
  reads equals what ``zstandard`` reads.
- Parity with the JAX package, with ``zstandard`` blocked in the port:
  TPUT frames of every dtype cross both ways compressed, a JAX spill
  writer and a port reader share one RESP store, and a JAX
  ``serialize_handoff`` and ``pack_message`` are read by the port (and the
  port's compressed message by JAX).
"""

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
zstandard = pytest.importorskip("zstandard")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from distributed_gpu_inference_torch import native as tnative  # noqa: E402
from distributed_gpu_inference_torch.utils import serialization as tser  # noqa: E402
from distributed_gpu_inference_torch.utils import zstd as tz  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "zstd"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
NATIVE = tnative.native_available(tnative.ZSTD_SRC)
needs_native = pytest.mark.skipif(not NATIVE, reason="no C++ compiler for the native codec")
SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])


def _sha(data) -> str:
    return hashlib.sha256(bytes(data)).hexdigest()


def _reference(frame):
    """``zstandard``'s answer: the bytes, or None where it refuses."""
    try:
        return zstandard.ZstdDecompressor().decompress(bytes(frame))
    except zstandard.ZstdError:
        return None


DECODERS = {"native": tz.decompress, "plain": tz.decompress_plain}


def _tensor_payload(kind: str, n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        x = rng.standard_normal(n // 2).astype(np.float32) * 0.7
        return (x.view(np.uint32) >> 16).astype(np.uint16).tobytes()
    if kind == "f32":
        return (rng.standard_normal(n // 4) * 3).astype(np.float32).tobytes()
    if kind == "int8":
        return np.clip(rng.standard_normal(n) * 30, -127, 127).astype(np.int8).tobytes()
    if kind == "int8_uniform":
        return rng.integers(-128, 128, n).astype(np.int8).tobytes()
    raise AssertionError(kind)


# -- the fixtures ------------------------------------------------------------------------

@pytest.mark.parametrize("decoder", list(DECODERS))
@pytest.mark.parametrize("entry", MANIFEST["frames"], ids=lambda e: e["file"])
def test_fixtures_decode_as_zstandard_does(entry, decoder):
    if decoder == "native" and not NATIVE:
        pytest.skip("no C++ compiler for the native codec")
    frame = (FIXTURES / entry["file"]).read_bytes()
    assert _sha(frame) == entry["file_sha256"]
    fn = DECODERS[decoder]
    if "refused" in entry:
        exc = tz.CodecUnavailable if entry["refused"] == "dictionary" else ValueError
        with pytest.raises(exc, match="dictionar" if exc is tz.CodecUnavailable else None):
            fn(frame)
        assert _reference(frame) is None
        return
    out = fn(frame)
    assert len(out) == entry["content_bytes"] and _sha(out) == entry["content_sha256"]
    assert bytes(out) == _reference(frame)
    # the size the TPUT reader expects is the declared one; another is refused
    assert bytes(fn(frame, expected_size=entry["content_bytes"])) == bytes(out)
    with pytest.raises(ValueError, match="expected"):
        fn(frame, expected_size=entry["content_bytes"] + 1)


def test_the_fixture_set_covers_the_frame_format():
    names = {e["file"] for e in MANIFEST["frames"]}
    assert {"level_m5.zst", "level_1.zst", "level_3.zst", "level_9.zst", "level_19.zst",
            "checksum.zst", "no_checksum.zst", "multiblock.zst", "bf16_page.zst",
            "f32_logits.zst", "zero_page.zst", "int8_uniform.zst", "concatenated.zst",
            "no_content_size.zst", "dictionary.zst", "truncated.zst",
            "rle_past_block_max.zst", "raw_past_window.zst", "match_past_window.zst"} <= names
    by = {e["file"]: e for e in MANIFEST["frames"]}
    assert by["multiblock.zst"]["content_bytes"] > 128 * 1024
    assert tz.frame_header((FIXTURES / "checksum.zst").read_bytes()).checksum
    assert not tz.frame_header((FIXTURES / "no_checksum.zst").read_bytes()).checksum
    assert sum(e["bytes"] for e in MANIFEST["frames"]) < 1_000_000


# -- hypothesis: libzstd's frames ----------------------------------------------------------

payloads = st.one_of(
    st.binary(max_size=3000),
    st.builds(lambda b, k: (b * k)[:200_000], st.binary(min_size=1, max_size=40),
              st.integers(1, 6000)),
    st.builds(_tensor_payload, st.sampled_from(["bf16", "f32", "int8", "int8_uniform"]),
              st.integers(1, 70_000), st.integers(0, 2**16)),
)


@SETTINGS
@given(data=payloads, level=st.sampled_from([-5, -1, 1, 3, 9, 19]), checksum=st.booleans())
def test_libzstd_frames_decode_to_their_input(data, level, checksum):
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    if NATIVE:
        assert bytes(tz.decompress(frame)) == data
    if len(frame) < 20_000:
        assert bytes(tz.decompress_plain(frame)) == data
    # only the first frame counts
    tail = zstandard.ZstdCompressor().compress(b"second frame")
    if NATIVE:
        assert bytes(tz.decompress(frame + tail)) == data
    if len(frame) < 20_000:
        assert bytes(tz.decompress_plain(frame + tail)) == data


def test_frame_headers_and_their_refusals():
    c = zstandard.ZstdCompressor(level=3)
    assert bytes(tz.decompress(c.compress(b""))) == b""
    # every content-size width zstandard writes
    for n in (0, 1, 255, 256, 65791, 65792, 1 << 20):
        data = bytes(range(256)) * (n // 256) + bytes(n % 256)
        h = tz.frame_header(c.compress(data))
        assert h.content_size == n and h.window_size == n
        if n < 70_000:
            assert bytes(tz.decompress_plain(c.compress(data))) == data
    # past its window libzstd writes a window descriptor beside the size
    rng = np.random.default_rng(1)
    big = rng.integers(0, 16, 3 << 20, dtype=np.uint8).tobytes()
    frame = zstandard.ZstdCompressor(level=1).compress(big)
    h = tz.frame_header(frame)
    assert h.content_size == len(big) and h.window_size < len(big)
    if NATIVE:
        assert bytes(tz.decompress(frame)) == big
    # no content size is refused; a skippable frame of 0 bytes reads as
    # b"", as there; a frame too short or not a frame is refused
    nocs = zstandard.ZstdCompressor(write_content_size=False).compress(b"abc" * 1000)
    assert tz.frame_header(nocs).content_size is None
    for fn in DECODERS.values():
        with pytest.raises(ValueError, match="content size"):
            fn(nocs)
        assert bytes(fn(b"\x50\x2a\x4d\x18" + bytes(4) + b"trailing")) == b""
        with pytest.raises(ValueError):
            fn(b"\x28\xb5\x2f")
        with pytest.raises(ValueError):
            fn(b"not a frame at all")
    # a declared size that differs from the expected one is refused before
    # anything is allocated: 2**40 bytes, a bomb
    bomb = b"\x28\xb5\x2f\xfd\xe0" + (1 << 40).to_bytes(8, "little") + b"\x01\x00\x00"
    for fn in DECODERS.values():
        with pytest.raises(ValueError, match="1099511627776 bytes, 16 expected"):
            fn(bomb, expected_size=16)


def test_xxh64_matches_the_frame_checksums():
    # every length class of XXH64's tail; the native decoder checks the
    # same checksums on every checksummed frame it reads
    rng = np.random.default_rng(0)
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000, 4099):
        data = rng.bytes(n)
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert tz.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")
        if NATIVE and n:
            assert bytes(tz.decompress(frame)) == data
            bad = frame[:-1] + bytes([frame[-1] ^ 1])
            with pytest.raises(ValueError, match="checksum"):
                tz.decompress(bad)


# -- the encoder -------------------------------------------------------------------------

@needs_native
@SETTINGS
@given(data=payloads)
def test_port_frames_decode_through_zstandard(data):
    frame = tz.compress(data)
    assert tz.frame_header(frame).content_size == len(data)
    assert not tz.frame_header(frame).checksum
    if data:
        assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert bytes(tz.decompress(frame)) == data
    if len(frame) < 20_000:
        assert bytes(tz.decompress_plain(frame)) == data


@needs_native
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "int8_uniform"])
@pytest.mark.parametrize("size", [4096, 65536, 524288, 2_100_000])
def test_port_frames_are_within_2_percent_of_level_3(kind, size):
    data = _tensor_payload(kind, size, seed=size)
    ours = len(tz.compress(data))
    level3 = len(zstandard.ZstdCompressor(level=3).compress(data))
    assert ours <= 1.02 * level3, (ours, level3)


@needs_native
@pytest.mark.parametrize("size", [65536, 262144, 1 << 22])
def test_an_all_zero_page_is_under_1_percent(size):
    frame = tz.compress(bytes(size))
    assert len(frame) < size / 100
    assert bytes(tz.decompress(frame)) == bytes(size)


@needs_native
def test_mixed_payloads_and_levels_round_trip():
    rng = np.random.default_rng(7)
    page = np.zeros((2, 2, 8, 16, 64), np.float32)
    page[:, :, :3] = rng.standard_normal((2, 2, 3, 16, 64))     # a partly filled KV page
    for data in (page.tobytes(), (b"worker: eu-west\n" * 9000) + rng.bytes(5000),
                 bytes(rng.integers(0, 3, 400_000, dtype=np.uint8))):
        frame = tz.compress(data)
        assert zstandard.ZstdDecompressor().decompress(frame) == data
        assert bytes(tz.decompress(frame)) == data
        assert len(frame) <= 1.02 * len(zstandard.ZstdCompressor().compress(data))
        # libzstd's frames of the same payloads at every level read back
        for level in (-3, 1, 3, 9, 19):
            theirs = zstandard.ZstdCompressor(level=level).compress(data)
            assert bytes(tz.decompress(theirs)) == data


# -- fallbacks -------------------------------------------------------------------------

def test_without_the_library_the_plain_decoder_and_raw_frames_are_taken(monkeypatch):
    monkeypatch.setattr(tnative, "_lib", {tnative.ZSTD_SRC: None})
    monkeypatch.setattr(tnative, "_lib_tried", True)
    monkeypatch.setattr(tnative, "PLAIN_TAKEN", {})
    data = _tensor_payload("bf16", 8192, 1)
    frame = zstandard.ZstdCompressor().compress(data)
    assert bytes(tz.decompress(frame)) == data
    assert tz.compress(data) is None
    t = torch.frombuffer(bytearray(data), dtype=torch.bfloat16)
    wire = tser.serialize(t, compress=True)
    assert wire[5] == 0 and torch.equal(tser.deserialize(wire), t)       # written raw
    assert tnative.PLAIN_TAKEN == {"zstd_decompress": 1, "zstd_compress": 2}


# -- corrupt input, in a child process ------------------------------------------------

CHILD = """
import hashlib, json, sys
sys.path.insert(0, {root!r})
{setup}
from distributed_gpu_inference_torch import native
from distributed_gpu_inference_torch.utils import zstd
said = {{}}
for name, (path, plain) in json.load(open({plan!r})).items():
    data = open(path, "rb").read()
    for dn, fn in (("native", zstd.decompress), ("plain", zstd.decompress_plain)):
        if dn == "plain" and not plain:
            continue
        try:
            said[name + " / " + dn] = hashlib.sha256(bytes(fn(data))).hexdigest()
        except (ValueError, zstd.CodecUnavailable) as exc:
            said[name + " / " + dn] = "refused"
print(json.dumps({{"said": said, "plain_taken": native.PLAIN_TAKEN}}))
"""


def corruption_cases():
    """Truncations and 1-3 flipped bytes of frames from both encoders:
    Huffman literals in 1 and 4 streams, sequences, RLE and raw blocks,
    with and without a checksum."""
    rng = np.random.default_rng(0)
    text = b"".join(rng.choice([b"worker ", b"region ", b"eu-west ", b"0.25 ", b"\n"], 6000))
    sources = {
        "l3 text": zstandard.ZstdCompressor(level=3).compress(text),
        "l19 text checksum": zstandard.ZstdCompressor(level=19, write_checksum=True)
        .compress(text),
        "l1 bf16": zstandard.ZstdCompressor(level=1).compress(_tensor_payload("bf16", 9000, 2)),
        "small": zstandard.ZstdCompressor(level=3).compress(text[:300]),
    }
    if NATIVE:
        sources["port int8"] = tz.compress(_tensor_payload("int8", 20000, 3))
        sources["port text"] = tz.compress(text)
        sources["port zeros+noise"] = tz.compress(bytes(5000) + rng.bytes(300) + bytes(3000))
    cases = {}
    for tag, frame in sources.items():
        for n in range(0, len(frame), max(1, len(frame) // 40)):
            cases[f"{tag} cut at {n}"] = frame[:n]
        for i in range(60):
            b = bytearray(frame)
            for p in rng.integers(4, len(b), size=int(rng.integers(1, 4))):
                b[p] ^= 1 << int(rng.integers(0, 8))
            cases[f"{tag} flip {i}"] = bytes(b)
    return cases


def decode_in_child(tmp_path, cases, plain_every=1, setup="", env=None):
    plan = {}
    for i, (name, data) in enumerate(cases.items()):
        path = tmp_path / f"case{i}.zst"
        path.write_bytes(data)
        plan[name] = (str(path), bool(plain_every) and i % plain_every == 0 and len(data) < 8000)
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    probe = CHILD.format(root=str(ROOT), setup=setup, plan=str(tmp_path / "plan.json"))
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _check_against_zstandard(cases, said):
    for name, data in cases.items():
        ref = _reference(data)
        for dn in ("native", "plain"):
            key = f"{name} / {dn}"
            if key not in said:
                continue
            if ref is None:
                assert said[key] == "refused", key           # refused where zstandard refuses
            elif said[key] != "refused":
                assert said[key] == _sha(ref), key            # and never other bytes


@needs_native
def test_corrupt_frames_are_refused_and_never_crash(tmp_path):
    cases = corruption_cases()
    got = decode_in_child(tmp_path, cases, plain_every=3)
    assert got["plain_taken"] == {}
    _check_against_zstandard(cases, got["said"])
    refused = sum(v == "refused" for v in got["said"].values())
    assert refused > len(cases) // 2


def _asan_runtime():
    import shutil

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
def test_corrupt_frames_under_address_sanitizer(tmp_path, monkeypatch):
    """The corruption cases and the fixtures once more against a
    ``-fsanitize=address`` build of the codec: a read or write out of
    bounds ends the child with an error."""
    build = tmp_path / "asan"
    monkeypatch.setattr(tnative, "BUILD_DIR", build)
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ASAN_FLAGS)
    # built here, so that the compiler does not run under the preloaded runtime
    assert tnative._compile(tnative.ZSTD_SRC, tnative.library_path(tnative.ZSTD_SRC))
    cases = corruption_cases()
    cases.update({e["file"]: (FIXTURES / e["file"]).read_bytes() for e in MANIFEST["frames"]})
    env = dict(os.environ, LD_PRELOAD=_asan_runtime(), ASAN_OPTIONS="detect_leaks=0")
    got = decode_in_child(tmp_path, cases, plain_every=0, env=env,
                          setup=ASAN_SETUP.format(build=str(build), flags=ASAN_FLAGS))
    assert got["plain_taken"] == {} and len(got["said"]) == len(cases)
    _check_against_zstandard(cases, got["said"])
    assert [p.name for p in build.iterdir()] == [tnative.library_path(tnative.ZSTD_SRC).name]


# -- parity with the JAX package, zstandard blocked in the port ---------------------------

ml_dtypes = pytest.importorskip("ml_dtypes")


@pytest.fixture
def no_pip_codecs(monkeypatch):
    """``import zstandard`` / ``import yaml`` fail from here on; the JAX
    modules imported before keep theirs."""
    from distributed_gpu_inference_tpu.utils import serialization  # noqa: F401

    monkeypatch.setitem(sys.modules, "zstandard", None)
    monkeypatch.setitem(sys.modules, "yaml", None)


WIRE_DTYPES = {"float32": np.float32, "float16": np.float16, "bfloat16": ml_dtypes.bfloat16,
               "float8_e4m3fn": ml_dtypes.float8_e4m3fn, "int8": np.int8, "uint8": np.uint8,
               "int32": np.int32, "int64": np.int64}


def _np_array(name, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 4
    x[..., : shape[-1] // 2] = 0          # half zeros: every dtype compresses
    if name in ("int8", "uint8", "int32", "int64"):
        return np.clip(x, -100, 100).astype(WIRE_DTYPES[name])
    return x.astype(np.float32).astype(WIRE_DTYPES[name])


@needs_native
@pytest.mark.parametrize("name", list(WIRE_DTYPES))
def test_tput_frames_of_every_dtype_cross_compressed(name, no_pip_codecs):
    from distributed_gpu_inference_tpu.utils.serialization import TensorSerializer

    arr = _np_array(name, (4, 2, 16, 64), seed=len(name))
    jax_frame = TensorSerializer(compress=True).serialize(arr)
    assert jax_frame[5] & 1
    got = tser.deserialize(jax_frame)
    assert tser.wire_dtype_name(got.dtype) == name and tuple(got.shape) == arr.shape
    assert bytes(got.reshape(-1).view(torch.uint8).numpy()) == arr.tobytes()
    mine = tser.serialize(got, compress=True)
    assert mine[5] & 1 and len(mine) <= 1.02 * len(jax_frame)
    back = TensorSerializer().deserialize(mine)
    assert back.dtype == arr.dtype and back.tobytes() == arr.tobytes()
    # below the JAX threshold, and uncompressed on request: raw, as JAX writes it
    small = arr.reshape(-1)[:100]
    assert tser.serialize(torch.from_numpy(small.view(np.uint8).copy()).view(got.dtype),
                          compress=True)[5] == 0
    assert tser.serialize(got) == TensorSerializer(compress=False).serialize(arr)


@needs_native
def test_jax_spill_entries_are_hits_on_a_shared_resp_store(no_pip_codecs):
    from test_redis_kv import FakeRedisServer

    from distributed_gpu_inference_tpu.runtime import kv_cache as jkv
    from distributed_gpu_inference_tpu.runtime.redis_kv import RedisKVStore as JRedis
    from distributed_gpu_inference_torch.runtime import kv_cache as tkv
    from distributed_gpu_inference_torch.runtime.redis_kv import RedisKVStore as TRedis

    rng = np.random.default_rng(4)
    page = np.zeros((2, 2, 2, 16, 64), ml_dtypes.bfloat16)
    page[..., :6, :] = rng.standard_normal((2, 2, 2, 6, 64)).astype(ml_dtypes.bfloat16)
    srv = FakeRedisServer()
    jstore = JRedis(host="127.0.0.1", port=srv.port)
    tstore = TRedis(host="127.0.0.1", port=srv.port)
    try:
        raw = jkv._pack_spill(page, None)
        assert raw[8 + 8 + 5] & 1                        # the JAX writer compressed it
        jstore.put("blk", raw)
        assert jstore.flush()                            # the write-back queue drained
        mgr = tkv.PagedKVCacheManager(8, 16, host_store=None, spill_on_evict=True,
                                      remote_store=tstore, kv_dtype=torch.bfloat16)
        hit = mgr._probe_spill("blk")
        assert hit is not None and mgr.stats.l3_hits == 1 and mgr.codec_misses == 0
        assert bytes(hit[0].reshape(-1).view(torch.uint8).numpy()) == page.tobytes()
        # and the port's compressed entry is a JAX hit
        tstore.put("blk2", tkv._pack_spill(hit[0], None))
        assert tstore.flush()
        jp, _ = jkv._unpack_spill(jstore.get("blk2"))
        assert jp.tobytes() == page.tobytes()
    finally:
        jstore.close()
        tstore.close()
        srv.close()


@needs_native
def test_jax_messages_and_handoffs_are_read_by_the_port(no_pip_codecs):
    from distributed_gpu_inference_tpu.comm import wire as jwire
    from distributed_gpu_inference_torch.comm import wire as twire

    rng = np.random.default_rng(6)
    hidden = rng.standard_normal((1, 24, 256)).astype(np.float32)
    logits = rng.standard_normal((1, 24, 1000)).astype(np.float32)
    msg = jwire.pack_message({"session_id": "s", "n": 3}, {"hidden": hidden, "logits": logits})
    assert msg != jwire.pack_message({"session_id": "s", "n": 3},
                                     {"hidden": hidden, "logits": logits}, compress=False)
    meta, tensors = twire.unpack_message(msg)
    assert meta == {"session_id": "s", "n": 3}
    assert np.array_equal(tensors["hidden"].numpy(), hidden)
    assert np.array_equal(tensors["logits"].numpy(), logits)
    mine = twire.pack_message(meta, tensors)
    assert len(mine) < 0.97 * len(twire.pack_message(meta, tensors, compress=False))
    jmeta, jt = jwire.unpack_message(mine)
    assert jmeta == meta and np.array_equal(jt["logits"], logits)
    assert twire.pack_message(meta, tensors, compress=False) == jwire.pack_message(
        meta, {"hidden": hidden, "logits": logits}, compress=False)
