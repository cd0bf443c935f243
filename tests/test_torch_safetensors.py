"""The port's safetensors reader (``utils/safetensors.py``) against files the
``safetensors`` library writes (its numpy and torch front ends), and the
library against ``chip_smoke.py``'s writer: every dtype bit for bit,
``__metadata__``, scalars and empty tensors, unaligned data, views that
outlive the file, and each refusal of a malformed file."""

import json
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
st_numpy = pytest.importorskip("safetensors.numpy")
st_torch = pytest.importorskip("safetensors.torch")

import chip_smoke  # noqa: E402
from distributed_gpu_inference_torch.utils.safetensors import (  # noqa: E402
    DTYPES,
    SafetensorsFile,
)


def load_file(path):
    """Every tensor of one file, copied out of the mapping."""
    with SafetensorsFile(path) as f:
        return {name: f.get_tensor(name).clone() for name in f.keys()}


def _bits(t):
    """A tensor's raw bytes (bf16 / fp8 compared as bits, never as values)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _torch_tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=g).bool()
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 50).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape, generator=g,
                         dtype=torch.int64).to(dtype)


TORCH_DTYPES = sorted(DTYPES.items())


@pytest.mark.parametrize("name,dtype", TORCH_DTYPES, ids=[n for n, _ in TORCH_DTYPES])
def test_reads_every_dtype_written_by_safetensors_torch(tmp_path, name, dtype):
    tensors = {"a": _torch_tensor(dtype, (3, 5), 0), "b.c": _torch_tensor(dtype, (7,), 1),
               "scalar": _torch_tensor(dtype, (), 2), "empty": _torch_tensor(dtype, (0, 4), 3)}
    path = tmp_path / "x.safetensors"
    st_torch.save_file(tensors, str(path), metadata={"format": "pt", "k": "v"})
    with SafetensorsFile(path) as f:
        assert f.keys() == sorted(tensors)
        assert f.metadata() == {"format": "pt", "k": "v"}
        for key, want in tensors.items():
            got = f.get_tensor(key)
            assert got.dtype == dtype and got.shape == want.shape
            assert _bits(got) == _bits(want), key


NUMPY_DTYPES = [np.float16, np.float32, np.float64, np.int8, np.uint8, np.int16, np.int32,
                np.int64, np.bool_]


@pytest.mark.parametrize("dtype", NUMPY_DTYPES, ids=[np.dtype(d).name for d in NUMPY_DTYPES])
def test_reads_every_dtype_written_by_safetensors_numpy(tmp_path, dtype):
    rng = np.random.default_rng(0)
    arrays = {"w": (rng.standard_normal((4, 6)) * 100).astype(dtype),
              "s": np.asarray(rng.standard_normal() * 100).astype(dtype),
              "z": np.zeros((0,), dtype)}
    path = tmp_path / "n.safetensors"
    st_numpy.save_file(arrays, str(path))
    got = load_file(path)
    assert set(got) == set(arrays)
    for key, want in arrays.items():
        assert tuple(got[key].shape) == want.shape
        np.testing.assert_array_equal(got[key].numpy(), want)


def test_views_are_zero_copy_and_outlive_the_file(tmp_path):
    path = tmp_path / "v.safetensors"
    want = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    st_torch.save_file({"w": want}, str(path))
    with SafetensorsFile(path) as f:
        a, b = f.get_tensor("w"), f.get_tensor("w")
        assert a.data_ptr() == b.data_ptr()        # one mapping, no copies
        a[0, 0] = -1.0                             # copy-on-write: the file is untouched
        with pytest.raises(KeyError, match="no tensor"):
            f.get_tensor("v")
    with pytest.raises(ValueError, match="closed"):
        f.get_tensor("w")
    del f, a
    assert float(b[0, 0]) == -1.0 and torch.equal(b[1:], want[1:])
    assert torch.equal(load_file(path)["w"], want)


def _raw_file(path, header, data):
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)
    return path


def test_unaligned_tensors_are_read_exactly(tmp_path):
    # a 3-byte U8 tensor puts the F32 after it at an odd offset
    f32 = np.array([1.5, -2.25, 3.0e-8], np.float32)
    path = _raw_file(tmp_path / "u.safetensors", {
        "a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
        "b": {"dtype": "F32", "shape": [3], "data_offsets": [3, 15]}},
        b"\x01\x02\x03" + f32.tobytes())
    got = load_file(path)
    assert got["a"].tolist() == [1, 2, 3]
    np.testing.assert_array_equal(got["b"].numpy(), f32)
    assert st_numpy.load_file(str(path))["b"].tobytes() == f32.tobytes()


@pytest.mark.parametrize("case,match", [
    ("too_short", "too short"),
    ("header_past_end", "longer than the file"),
    ("not_json", "not JSON"),
    ("unknown_dtype", "unknown dtype 'Q7'"),
    ("out_of_bounds", "lie outside"),
    ("overlap", "overlaps"),
    ("byte_count", "do not match shape"),
    ("bad_shape", "bad shape"),
])
def test_malformed_files_are_refused_naming_file_and_tensor(tmp_path, case, match):
    path = tmp_path / f"{case}.safetensors"
    data = bytes(64)
    entry = {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}
    if case == "too_short":
        path.write_bytes(b"\x05\x00")
    elif case == "header_past_end":
        path.write_bytes(struct.pack("<Q", 1 << 20) + b"{}")
    elif case == "not_json":
        path.write_bytes(struct.pack("<Q", 4) + b"{no}")
    elif case == "unknown_dtype":
        _raw_file(path, {"w": dict(entry, dtype="Q7")}, data)
    elif case == "out_of_bounds":
        _raw_file(path, {"w": dict(entry, shape=[32], data_offsets=[0, 128])}, data)
    elif case == "overlap":
        _raw_file(path, {"w": entry, "v": dict(entry, data_offsets=[8, 24])}, data)
    elif case == "byte_count":
        _raw_file(path, {"w": dict(entry, shape=[5])}, data)
    elif case == "bad_shape":
        _raw_file(path, {"w": dict(entry, shape=[-4])}, data)
    with pytest.raises(ValueError, match=match) as info:
        SafetensorsFile(path)
    assert str(path) in str(info.value)
    if case not in ("too_short", "header_past_end", "not_json"):
        assert "'w'" in str(info.value) or "'v'" in str(info.value)


def test_library_reads_chip_smoke_writer(tmp_path):
    g = torch.Generator().manual_seed(3)
    tensors = {
        "model.embed_tokens.weight": torch.randn((11, 6), generator=g).to(torch.bfloat16),
        "odd": torch.arange(5, dtype=torch.int8),           # leaves later data unaligned
        "norm": torch.randn((6,), generator=g),
        "codes": torch.randn((3, 4), generator=g).to(torch.float8_e4m3fn),
        "ids": torch.arange(3, dtype=torch.int64),
        "scalar": torch.tensor(2.5, dtype=torch.float16),
        "empty": torch.empty((0, 3), dtype=torch.bfloat16),
    }
    entries = [(k, v.dtype, tuple(v.shape), (lambda v=v: v)) for k, v in tensors.items()]
    path = tmp_path / "w.safetensors"
    n = chip_smoke.write_safetensors(path, entries, metadata={"format": "pt"})
    assert n == path.stat().st_size
    lib = st_torch.load_file(str(path))
    ours = load_file(path)
    for key, want in tensors.items():
        assert lib[key].dtype == want.dtype and _bits(lib[key]) == _bits(want), key
        assert ours[key].dtype == want.dtype and _bits(ours[key]) == _bits(want), key
    with SafetensorsFile(path) as f:
        assert f.metadata() == {"format": "pt"}


def test_chip_smoke_writer_refuses_a_tensor_unlike_its_declaration(tmp_path):
    with pytest.raises(AssertionError, match="declared"):
        chip_smoke.write_safetensors(tmp_path / "x.safetensors", [
            ("w", torch.float32, (2, 2), lambda: torch.zeros((2, 3)))])
