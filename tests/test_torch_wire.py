"""The port's ``comm/wire.py`` against the JAX package's: the ``TPUM``
message a pipeline hop carries. The port writes uncompressed frames, byte
for byte what JAX's ``pack_message(..., compress=False)`` writes; each
package reads the other's messages, zstd-compressed JAX ones included;
both refuse a bad magic or version. Tensors are compared exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_gpu_inference_torch.comm import wire as twire  # noqa: E402
from distributed_gpu_inference_tpu.comm import wire as jwire  # noqa: E402


def _messages():
    rng = np.random.default_rng(0)
    return {
        "hop": ({"session_id": "s1", "kv_len_after": 12},
                {"x": np.arange(12, dtype=np.int32).reshape(3, 4),
                 "positions": np.full((3, 4), -1, np.int32)}),
        "hidden": ({"session_id": "abc" * 20, "kv_len_after": 70000},
                   {"x": rng.normal(size=(2, 3, 8)).astype(np.float32),
                    "positions": np.arange(6, dtype=np.int32).reshape(2, 3)}),
        "reply": ({"session_id": "s", "score": 0.25, "flags": [True, None]},
                  {"hidden": rng.normal(size=(1, 1, 64)).astype(np.float32),
                   "logits": rng.normal(size=(1, 1, 512)).astype(np.float32)}),
        "empty": ({"session_id": "e"}, {}),
        "scalar": ({}, {"z": np.asarray(3.5, np.float32),
                        "none": np.zeros((0, 4), np.int32)}),
    }


MESSAGES = _messages()


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_port_bytes_equal_jax_uncompressed(name):
    meta, tensors = MESSAGES[name]
    port = twire.pack_message(meta, tensors)
    assert port == jwire.pack_message(meta, tensors, compress=False)
    # torch tensors give the same bytes as numpy arrays
    assert twire.pack_message(meta, {k: torch.from_numpy(v.copy())
                                     for k, v in tensors.items()}) == port


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_port_reads_jax_messages(name, compress):
    meta, tensors = MESSAGES[name]
    got_meta, got = twire.unpack_message(jwire.pack_message(meta, tensors, compress=compress))
    assert got_meta == meta and list(got) == list(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == torch.from_numpy(v).dtype and tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_jax_reads_port_messages(name):
    meta, tensors = MESSAGES[name]
    got_meta, got = jwire.unpack_message(twire.pack_message(meta, tensors))
    assert got_meta == meta and list(got) == list(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)


def test_port_reads_a_zstd_frame_of_jax():
    # a compressible tensor: JAX's writer sets the zstd flag on its frame
    x = np.zeros((64, 256), np.float32)
    blob = jwire.pack_message({"session_id": "z"}, {"x": x})
    assert len(blob) < x.nbytes        # compressed on the wire
    _, got = twire.unpack_message(blob)
    np.testing.assert_array_equal(got["x"].numpy(), x)


def test_bf16_tensors_cross_as_raw_bits():
    t = torch.randn(3, 5).to(torch.bfloat16)
    _, got = twire.unpack_message(twire.pack_message({}, {"h": t}))
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], t)
    _, jgot = jwire.unpack_message(twire.pack_message({}, {"h": t}))
    assert jgot["h"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(jgot["h"].view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("blob,match", [
    (b"nope" + b"\x00" * 16, "bad magic"),
    (b"TPUM\x02" + b"\x00" * 16, "unsupported message version 2"),
])
def test_both_refuse_a_bad_magic_or_version(blob, match):
    for mod in (twire, jwire):
        with pytest.raises(ValueError, match=match):
            mod.unpack_message(blob)


@pytest.mark.parametrize("cut", [5, 9, 20, -9])
def test_port_refuses_a_cut_message(cut):
    meta, tensors = MESSAGES["hop"]
    blob = twire.pack_message(meta, tensors)
    with pytest.raises(ValueError):
        twire.unpack_message(blob[:cut])
