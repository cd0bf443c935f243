"""The KV handoff across both packages (CPU, f32, ``llama3-tiny`` and
``mistral-tiny``, the same weights on both sides through
``models/convert.py``): the hand-written msgpack codec against ``msgpack``;
the handoff frames' malformed cases; a JAX ``serialize_handoff(...,
compress=False)`` and the port's byte-identical for the same state, both
ways, for f32 and int8 pools, and every streamed message re-encoded by the
port byte-identical to the JAX writer's; JAX export → port adopt and port
export → JAX adopt, one-shot and streamed, each continuing greedy-identical
to an uninterrupted JAX run (greedy ids compared exactly); a JAX zstd blob;
the sliding-window state; a first-token stop; rejections that leak nothing;
a receiver-side prefix hit; and ``migrate_kv_device`` between two CPU
engines (pages compared bit for bit)."""

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import kv_handoff as tkh  # noqa: E402
from distributed_gpu_inference_torch.runtime.kv_cache import OutOfBlocksError  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.utils import serialization as tser  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import kv_handoff as jkh  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
GEOM = dict(max_batch_size=2, max_seq_len=128, block_size=16,
            prefill_buckets=(16, 32, 64), dtype="float32", multi_step=4)
NEW = 12
PROMPT = [(i * 37 + 11) % 500 for i in range(40)]        # 3 blocks
LONG = [(i * 53 + 7) % 500 for i in range(90)]           # 2 prefill chunks, 6 blocks


def _req(ds, prompt=PROMPT, n=NEW, rid=None, **kw):
    extra = {} if rid is None else {"request_id": rid}
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, **kw), **extra)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name, seed in ((MODEL, 7), ("mistral-tiny", 8)):
        jp = jllama.init_params(get_model_config(name), jax.random.PRNGKey(seed), jnp.float32)
        out[name] = (jp, jax.tree.map(np.asarray, jp))
    return out


def _jax(weights, kv=None, model=MODEL):
    return jengine.TPUEngine(model, jengine.EngineConfig(**GEOM, kv_cache_dtype=kv),
                             params=weights[model][0])


def _port(weights, kv=None, model=MODEL, **over):
    return tengine.TorchEngine(model, tengine.EngineConfig(**dict(GEOM, kv_cache_dtype=kv,
                                                                  **over)),
                               params=params_from_numpy(weights[model][1], "cpu"),
                               device="cpu")


@pytest.fixture(scope="module")
def engines(weights):
    """JAX and port engines for the f32 pool (None) and the int8 pool."""
    return {kv: (_jax(weights, kv), _port(weights, kv)) for kv in (None, "int8")}


@pytest.fixture(scope="module")
def reference(engines):
    """Greedy ids of uninterrupted JAX runs, by (pool, prompt)."""
    out = {}
    for kv, (j, _) in engines.items():
        for name, prompt in (("short", PROMPT), ("long", LONG)):
            out[kv, name] = list(j.generate([_req(jds, prompt)])[0].token_ids)
            assert len(out[kv, name]) == NEW
    return out


def _steps(eng, slot, k):
    for _ in range(k):
        eng.decode_step()
    assert eng.slots[slot].finish_reason is None


def _finish(eng, slot):
    while eng.slots[slot].finish_reason is None:
        eng.decode_step()
    return list(eng.finish_slot(slot).token_ids)


# -- the msgpack codec


_leaf = (st.none() | st.booleans() | st.integers(-(2 ** 63), 2 ** 64 - 1)
         | st.floats(allow_nan=False) | st.text() | st.binary())
_obj = st.recursive(_leaf, lambda c: st.lists(c, max_size=20)
                    | st.dictionaries(st.text(), c, max_size=20), max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_obj)
def test_msgpack_codec_matches_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert tser.packb(obj) == want
    assert tser.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("n", [15, 16, 31, 32, 255, 256, 65535, 65536])
def test_msgpack_codec_length_boundaries(n):
    for obj in (list(range(n)), {str(i): -i for i in range(n)}, "s" * n, b"b" * n,
                [2 ** 32 - 1, -33, -129, -32769, -(2 ** 31) - 1, 1.5, None, True]):
        want = msgpack.packb(obj, use_bin_type=True)
        assert tser.packb(obj) == want
        assert tser.unpackb(want) == msgpack.unpackb(want, raw=False)


# -- frames (tests/test_kv_handoff_wire.py)


def test_read_blobs_roundtrip_and_bounds():
    blobs = [b"alpha", b"", b"x" * 1000]
    framed = tkh._frame_blobs(*blobs)
    assert framed == jkh._frame_blobs(*blobs)
    assert tkh._read_blobs(framed, 3) == blobs
    with pytest.raises(ValueError, match="malformed handoff frame"):
        tkh._read_blobs(tkh._frame_blobs(b"hello world")[:-3], 1)
    with pytest.raises(ValueError, match="malformed handoff frame"):
        tkh._read_blobs(tkh._frame_blobs(b"a", b"b")[: 8 + 1 + 4], 2)
    with pytest.raises(ValueError, match="overruns"):
        tkh._read_blobs((1 << 30).to_bytes(8, "little") + b"abc", 1)


@pytest.mark.parametrize("n_bytes", [4, 5, 9])
def test_unpack_stream_short_frame_raises_cleanly(n_bytes):
    msg = tkh._pack_stream(0, {"key": "k"})
    assert msg == jkh._pack_stream(0, {"key": "k"})
    with pytest.raises(ValueError, match="malformed handoff frame"):
        tkh._unpack_stream(msg[:n_bytes])


def test_unpack_stream_truncated_and_zero_length_headers_raise():
    msg = tkh._pack_stream(2, {"key": "k", "token_ids": list(range(64))})
    assert msg == jkh._pack_stream(2, {"key": "k", "token_ids": list(range(64))})
    with pytest.raises(ValueError, match="malformed handoff frame"):
        tkh._unpack_stream(msg[: len(msg) // 2])
    with pytest.raises(ValueError, match="malformed handoff frame"):
        tkh._unpack_stream(b"TPUS" + bytes([1, 0]) + (0).to_bytes(4, "little"))
    kind, meta, payload = tkh._unpack_stream(tkh._pack_stream(1, {"key": "k"}, b"p"))
    assert (kind, meta, payload) == (1, {"key": "k"}, b"p")


# -- one-shot: byte identity and greedy continuation across packages


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("k", [0, 3, 9])
def test_jax_export_adopts_in_the_port(engines, reference, kv, k):
    j, t = engines[kv]
    slot = j.submit(_req(jds))
    _steps(j, slot, k)
    jh = jkh.export_slot_kv(j, slot)
    j.finish_slot(slot, cache=False)
    raw = jkh.serialize_handoff(jh, compress=False)
    th = tkh.deserialize_handoff(raw)
    assert tkh.serialize_handoff(th, compress=False) == raw   # byte-identical re-encode
    assert (th.scale_pages is not None) == (kv == "int8")
    t.manager.clear_cached()
    before = t.manager.num_free
    tslot = tkh.adopt_kv(t, th)
    assert not t.manager.pending.uploads          # applied at the bind
    assert _finish(t, tslot) == reference[kv, "short"]
    t.manager.clear_cached()
    assert t.manager.num_free == before


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("k", [0, 5])
def test_port_export_adopts_in_jax(engines, reference, kv, k):
    j, t = engines[kv]
    slot = t.submit(_req(tds))
    _steps(t, slot, k)
    th = tkh.export_slot_kv(t, slot)
    t.finish_slot(slot, cache=False)
    raw = tkh.serialize_handoff(th, compress=False)
    jh = jkh.deserialize_handoff(raw)
    assert jkh.serialize_handoff(jh, compress=False) == raw
    if kv == "int8":
        assert jh.scale_pages.shape == (*th.pages.shape[:3], th.pages.shape[4],
                                        th.pages.shape[5])
    jslot = jkh.adopt_kv(j, jh)
    assert _finish(j, jslot) == reference[kv, "short"]


def test_jax_zstd_blob_is_read(engines, reference):
    pytest.importorskip("zstandard")
    j, t = engines[None]
    slot = j.submit(_req(jds))
    jh = jkh.export_slot_kv(j, slot)
    j.finish_slot(slot, cache=False)
    raw = jkh.serialize_handoff(jh)               # zstd frames (compress=True)
    assert raw != jkh.serialize_handoff(jh, compress=False)
    tslot = tkh.adopt_kv(t, tkh.deserialize_handoff(raw))
    assert _finish(t, tslot) == reference[None, "short"]


def test_first_token_stop_is_not_decoded_on_the_recipient(engines, reference):
    j, t = engines[None]
    first = reference[None, "short"][0]
    slot = j.submit(_req(jds, stop_token_ids=(first,)))
    assert j.slots[slot].finish_reason == "stop"
    raw = jkh.serialize_handoff(jkh.export_slot_kv(j, slot), compress=False)
    j.finish_slot(slot, cache=False)
    tslot = tkh.adopt_kv(t, tkh.deserialize_handoff(raw))
    calls = t.stats["decode_calls"]
    out = t.decode_step()
    assert tslot not in out and t.stats["decode_calls"] == calls
    resp = t.finish_slot(tslot)
    assert resp.token_ids == [] and resp.finish_reason == "stop"


def test_sliding_window_state_is_carried_and_streaming_refused(weights):
    j = _jax(weights, model="mistral-tiny")
    t = _port(weights, model="mistral-tiny")
    ref = list(j.generate([_req(jds)])[0].token_ids)
    slot = j.submit(_req(jds))
    _steps(j, slot, 4)
    jh = jkh.export_slot_kv(j, slot)
    j.finish_slot(slot, cache=False)
    assert jh.window_front >= 2
    th = tkh.deserialize_handoff(jkh.serialize_handoff(jh, compress=False))
    tslot = tkh.adopt_kv(t, th)
    s = t.slots[tslot]
    assert t.manager.seq_window_front[s.seq_id] == jh.window_front
    assert list(t._block_tables[tslot, :jh.window_front]) == [0] * jh.window_front
    assert _finish(t, tslot) == ref
    with pytest.raises(ValueError, match="sliding-window"):
        tkh.StreamedExport(t, _req(tds), "k")


def test_rejections_leak_no_blocks_and_no_staged_uploads(engines, weights):
    j, t = engines[None]
    slot = j.submit(_req(jds))
    raw = jkh.serialize_handoff(jkh.export_slot_kv(j, slot), compress=False)
    j.finish_slot(slot, cache=False)
    free0 = t.manager.num_free

    def clean():
        assert t.manager.num_free == free0 and t.num_active == 0
        assert not t.manager.pending.uploads and not t.manager.pending.scale_uploads

    h = tkh.deserialize_handoff(raw)
    h.model_name = "other-model"
    with pytest.raises(ValueError, match="model mismatch"):
        tkh.adopt_kv(t, h)
    clean()
    h = tkh.deserialize_handoff(raw)
    h.block_size = 32
    with pytest.raises(ValueError, match="block_size"):
        tkh.adopt_kv(t, h)
    clean()
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tkh.adopt_kv(engines["int8"][1], tkh.deserialize_handoff(raw))
    h = tkh.deserialize_handoff(raw)
    h.request.sampling.max_new_tokens = 10_000
    with pytest.raises(ValueError, match="headroom"):
        tkh.adopt_kv(t, h)
    clean()
    h = tkh.deserialize_handoff(raw)
    h.pages = h.pages[:, :, :, :, :, :-1]            # pages of another geometry
    with pytest.raises(ValueError, match="do not fit"):
        tkh.adopt_kv(t, h)
    clean()
    # a full engine: no free slot
    busy = [t.submit(_req(tds, [3, 4, 5], 4)) for _ in range(t.cfg.max_batch_size)]
    free_busy = t.manager.num_free
    with pytest.raises(RuntimeError, match="no free slots"):
        tkh.adopt_kv(t, tkh.deserialize_handoff(raw))
    assert t.manager.num_free == free_busy and not t.manager.pending.uploads
    for s in busy:
        t.finish_slot(s, cache=False)
    # a pool that cannot hold the chain: the allocation rolls back
    small = _port(weights, num_blocks=3)
    with pytest.raises(OutOfBlocksError):
        tkh.adopt_kv(small, tkh.deserialize_handoff(raw))
    assert small.manager.num_free == 2 and small.num_active == 0
    assert not small.manager.pending.uploads


# -- the device path


def test_migrate_kv_device_between_cpu_engines(engines, reference, weights):
    _, src = engines[None]
    dst = _port(weights)
    slot = src.submit(_req(tds))
    _steps(src, slot, 4)
    s = src.slots[slot]
    src_blocks = list(src.manager.seq_blocks[s.seq_id])
    dslot = tkh.migrate_kv_device(src, dst, slot)
    d = dst.slots[dslot]
    dst_blocks = list(dst.manager.seq_blocks[d.seq_id])
    for a, b in zip(src_blocks, dst_blocks):
        for key in src.kv:
            assert torch.equal(src.kv[key][:, a], dst.kv[key][:, b])
    assert d.generated == s.generated and int(dst._kv_lens[dslot]) == int(src._kv_lens[slot])
    assert list(dst._slot_keys[dslot]) == list(src._slot_keys[slot])
    src.finish_slot(slot, cache=False)
    assert _finish(dst, dslot) == reference[None, "short"]
    # mismatches raise before anything is allocated
    slot = src.submit(_req(tds))
    free = dst.manager.num_free
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tkh.migrate_kv_device(src, engines["int8"][1], slot)
    dst.device = torch.device("meta")                 # engines on two devices
    try:
        with pytest.raises(ValueError, match="one device"):
            tkh.migrate_kv_device(src, dst, slot)
    finally:
        dst.device = torch.device("cpu")
    assert dst.manager.num_free == free and dst.num_active == 0
    src.finish_slot(slot, cache=False)


# -- the streamed handoff


def _reencoded(msg):
    """The port's encoding of a parsed stream message."""
    kind, meta, payload = tkh._unpack_stream(msg)
    if kind != tkh._KIND_PIECE:
        return tkh._pack_stream(kind, meta, payload)
    blobs = tkh._read_blobs(payload, 2) if meta.get("has_scales") else [payload, None]
    pages, scales = tkh._read_pages(*blobs)
    return tkh._piece_frame(meta["key"], meta["block_lo"], pages, scales)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_streamed_jax_to_port(engines, reference, kv):
    j, t = engines[kv]
    j.manager.clear_cached()          # the reference run cached LONG's blocks
    exp = jkh.StreamedExport(j, _req(jds, LONG), "s-jt", piece_blocks=2)
    rx = tkh.HandoffReceiver(t)
    out = None
    msgs = list(exp.messages())
    assert exp.bytes_before_first_token > 0          # pieces before the first token
    for msg in msgs:
        assert _reencoded(msg) == msg
        out = rx.handle(msg)
    assert out["state"] == "committed" and j.num_active == 0
    assert _finish(t, out["slot"]) == reference[kv, "long"]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_streamed_port_to_jax(engines, reference, kv):
    j, t = engines[kv]
    t.manager.clear_cached()
    exp = tkh.StreamedExport(t, _req(tds, LONG), "s-tj", piece_blocks=2)
    rx = jkh.HandoffReceiver(j)
    out = None
    for msg in exp.messages():
        out = rx.handle(msg)
    assert out["state"] == "committed" and t.num_active == 0
    assert exp.first_token == reference[kv, "long"][0]
    assert exp.bytes_before_first_token > 0 and exp.pieces_sent == 3
    assert _finish(j, out["slot"]) == reference[kv, "long"]


def test_receiver_prefix_hit_skips_its_uploads(engines, reference, weights):
    j, _ = engines[None]
    t = _port(weights)
    t.generate([_req(tds, LONG, 2)])                   # LONG's full blocks cached
    rx = tkh.HandoffReceiver(t)
    results = [rx.handle(m) for m in
               jkh.StreamedExport(j, _req(jds, LONG), "s-hit", piece_blocks=2).messages()]
    assert results[0]["cached_tokens"] == 80          # 5 of 6 blocks resident
    staged = [r["blocks"] for r in results if r.get("state") == "staged"]
    assert staged == [0, 0, 1]                        # only the fresh block uploaded
    assert _finish(t, results[-1]["slot"]) == reference[None, "long"]
