"""The KV spill tiers of the PyTorch port against the JAX package (CPU).

- Wire: the port's ``TPUT`` frames (``utils/serialization.py``, a msgpack
  header written by hand) and ``SPL2`` spill entries (``_pack_spill`` /
  ``_unpack_spill``) cross between the packages both ways for bf16, int8
  with its scales (compact ``[L, 2, Bk]`` in the port, ``[L, 2, Bk, D]`` on
  the wire) and fp8 pages, zstd-compressed as the JAX serializer writes
  them or not; the port reads the JAX writer's zstd frames with
  ``zstandard`` blocked (its own codec, ``utils/zstd.py``), and a frame it
  cannot decode (one made with a dictionary) is a counted miss.
- Manager: the JAX ``PagedKVCacheManager`` and the port's, driven through
  the same allocations, frees and evictions, stage the same downloads and
  uploads and report the same ``get_stats()`` and ``spill_wire_stats()``,
  under the same fault plans too (breaker trips, the ``kv.block.alloc``
  pressure seam).
- Engine (``llama3-tiny``, f32 activations, bf16 and int8 KV pools, a pool
  of 8 blocks): pages spilled by eviction come back from L2 and from L3
  bitwise equal, and the greedy stream equals the JAX ``TPUEngine``'s on
  the same weights.
"""

import hashlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import msgpack  # noqa: E402

from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    params_from_numpy,
    tensor_to_words,
)
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import kv_cache as tkv  # noqa: E402
from distributed_gpu_inference_torch.testing import faults as tfaults  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.utils import serialization as tser  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import kv_cache as jkv  # noqa: E402
from distributed_gpu_inference_tpu.testing import faults as jfaults  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402
from distributed_gpu_inference_tpu.utils.serialization import TensorSerializer  # noqa: E402

NP_DTYPE = {"bfloat16": ml_dtypes.bfloat16, "float8_e4m3fn": ml_dtypes.float8_e4m3fn,
            "int8": np.int8, "float32": np.float32}


def _bits(a):
    a = tensor_to_words(a) if torch.is_tensor(a) else np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _np_tensor(rng, name, shape):
    if name == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return (rng.standard_normal(shape) * 3).astype(np.float32).astype(NP_DTYPE[name])


def _to_torch(a):
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------- wire


@pytest.mark.parametrize("name,shape", [
    ("bfloat16", (2, 2, 8, 16, 32)), ("int8", ()), ("float8_e4m3fn", (300, 70000)),
    ("float32", (5_000_000_000, 1, 17)), ("bfloat16", tuple(range(1, 18))),
])
def test_header_is_msgpacks_byte_for_byte(name, shape):
    want = msgpack.packb({"dtype": name, "shape": list(shape)}, use_bin_type=True)
    assert tser.pack_header(name, shape) == want
    assert tser.unpack_header(want) == (name, list(shape))


@pytest.mark.parametrize("name", ["bfloat16", "int8", "float8_e4m3fn", "float32"])
@pytest.mark.parametrize("compress", [False, True])
def test_tput_frames_cross_both_ways(name, compress):
    rng = np.random.default_rng(1)
    arr = _np_tensor(rng, name, (3, 2, 2, 16, 8))
    if compress:
        arr[1:] = arr[0]          # compressible: zstd shrinks it
    frame = TensorSerializer(compress=compress, min_compress_bytes=64).serialize(arr)
    assert bool(frame[5] & 1) == compress
    got = tser.deserialize(frame)
    assert got.dtype == _to_torch(arr).dtype and tuple(got.shape) == arr.shape
    assert np.array_equal(_bits(got), _bits(arr))
    # the port writes by the same rule, and the JAX serializer reads it
    mine = tser.serialize(_to_torch(arr), compress=compress, min_compress_bytes=64)
    assert bool(mine[5] & 1) == compress
    back = TensorSerializer().deserialize(mine)
    assert back.dtype == arr.dtype and np.array_equal(_bits(back), _bits(arr))
    if not compress:
        assert mine == frame      # the same bytes as the JAX writer's


@pytest.mark.parametrize("kind", ["bfloat16", "int8", "float8_e4m3fn"])
def test_spill_entries_cross_both_ways(kind):
    rng = np.random.default_rng(2)
    L, hkv, bk, d = 2, 2, 16, 8
    page = _np_tensor(rng, kind, (L, 2, hkv, bk, d))
    scale = None
    if kind == "int8":
        lanes = rng.uniform(0.01, 2, (L, 2, bk)).astype(np.float32).astype(ml_dtypes.bfloat16)
        scale = np.ascontiguousarray(np.broadcast_to(lanes[..., None], (L, 2, bk, d)))
    # JAX → port
    p, s = tkv._unpack_spill(jkv._pack_spill(page, scale))
    assert np.array_equal(_bits(p), _bits(page))
    assert (s is None) == (scale is None)
    if scale is not None:
        assert tuple(s.shape) == (L, 2, bk)
        assert np.array_equal(_bits(s), _bits(scale[..., 0]))
    # port → JAX
    tp = _to_torch(page)
    ts = None if scale is None else _to_torch(scale[..., 0])
    jp, js = jkv._unpack_spill(tkv._pack_spill(tp, ts))
    assert jp.dtype == page.dtype and np.array_equal(_bits(jp), _bits(page))
    if scale is not None:
        assert np.array_equal(_bits(js), _bits(scale))
    # a flipped byte is caught by the CRC on both sides
    raw = bytearray(tkv._pack_spill(tp, ts))
    raw[len(raw) // 2] ^= 0xFF
    with pytest.raises(tkv.SpillIntegrityError):
        tkv._unpack_spill(bytes(raw))
    with pytest.raises(jkv.SpillIntegrityError):
        jkv._unpack_spill(bytes(raw))


def _manager(**kw):
    return tkv.PagedKVCacheManager(8, 16, host_store=None, spill_on_evict=True, **kw)


def test_zstd_entry_without_zstandard_is_a_counted_miss(monkeypatch):
    # read without zstandard: the JAX writer's zstd entry is a hit
    rng = np.random.default_rng(3)
    page = np.zeros((4, 2, 2, 16, 32), ml_dtypes.bfloat16)     # compresses
    page[:, :, :, :4] = rng.standard_normal((4, 2, 2, 4, 32)).astype(ml_dtypes.bfloat16)
    raw = jkv._pack_spill(page, None)
    assert raw[8 + 8 + 5] & 1                   # the JAX writer's zstd flag
    store = tkv.RemoteKVStore()
    store.put("k", raw)
    mgr = _manager(remote_store=store, kv_dtype=torch.bfloat16)
    monkeypatch.setitem(sys.modules, "zstandard", None)        # import → ImportError
    got = mgr._probe_spill("k")
    assert got is not None and np.array_equal(_bits(got[0]), _bits(page))
    assert mgr.codec_misses == 0 and mgr.stats.l3_hits == 1


def test_zstd_entry_made_with_a_dictionary_is_a_counted_miss():
    # the one zstd frame the port cannot decode: a counted miss, the entry
    # left in place for peers that can read it
    page = np.zeros((4, 2, 2, 16, 32), ml_dtypes.bfloat16)
    frame = TensorSerializer(min_compress_bytes=64).serialize(page)
    header_end = 10 + int.from_bytes(frame[6:10], "little")
    packed = frame[header_end:]
    assert frame[5] & 1 and packed[4] & 0x20      # zstd, a single-segment frame
    # the same frame, its header naming dictionary 7
    packed = packed[:4] + bytes([packed[4] | 1, 7]) + packed[5:]
    frame = frame[:header_end] + packed
    body = len(frame).to_bytes(8, "little") + frame
    raw = b"SPL2" + __import__("zlib").crc32(body).to_bytes(4, "little") + body
    store = tkv.RemoteKVStore()
    store.put("k", raw)
    mgr = _manager(remote_store=store, kv_dtype=torch.bfloat16)
    assert mgr._probe_spill("k") is None
    assert mgr.codec_misses == 1
    assert mgr.spill_io["remote_quarantined_corrupt"] == 0
    assert "k" in store._store


def test_corrupt_and_mistyped_entries_degrade_to_misses():
    store = tkv.RemoteKVStore()
    page = torch.zeros((2, 2, 2, 16, 8), dtype=torch.bfloat16)
    good = tkv._pack_spill(page, None)
    store.put("rot", good[:-3] + b"xyz")
    store.put("bf16", good)
    mgr = _manager(remote_store=store, kv_dtype=torch.int8)
    assert mgr._probe_spill("rot") is None
    assert mgr.spill_io["remote_quarantined_corrupt"] == 1 and "rot" not in store._store
    # the dtype screen: a bf16 entry never reaches an int8 pool
    assert mgr._probe_spill("bf16") is None and mgr.stats.l3_hits == 0
    # nor one of another model's page shape
    other = _manager(remote_store=store, kv_dtype="bfloat16", page_shape=(4, 2, 2, 16, 8))
    assert other._probe_spill("bf16") is None
    same = _manager(remote_store=store, kv_dtype="bfloat16", page_shape=(2, 2, 2, 16, 8))
    assert same._probe_spill("bf16") is not None and same.stats.l3_hits == 1


# ---------------------------------------------------------------- manager parity

BLOCK = 4
PAGE = (2, 2, 1, BLOCK, 2)


def _page_for(key):
    """The bytes a block under ``key`` holds, the same on both sides."""
    words = np.frombuffer(hashlib.sha256(key.encode()).digest() * 4, np.float32)
    return np.ascontiguousarray(words[:int(np.prod(PAGE))].reshape(PAGE))


class _ManagerRun:
    """One manager plus an engine stand-in that applies its pending ops
    (downloads → store_spilled with :func:`_page_for`)."""

    def __init__(self, mod, host_blocks, tensors):
        self.mod, self.tensors = mod, tensors
        self.remote = mod.RemoteKVStore()
        self.mgr = mod.PagedKVCacheManager(
            10, BLOCK, host_store=mod.HostKVStore(host_blocks),
            remote_store=self.remote, spill_on_evict=True,
            kv_dtype="float32" if tensors else np.float32)
        self.log = []

    def apply(self):
        ops = self.mgr.take_pending_ops()
        self.log.append(("downloads", [k for _, k in ops.downloads]))
        for _, key in ops.downloads:
            page = _page_for(key)
            self.mgr.store_spilled(key, torch.from_numpy(page.copy()) if self.tensors else page)
        self.log.append(("uploads", [(b, _bits(p).tobytes()) for b, p in ops.uploads]))
        self.log.append(("copies", list(ops.copies)))

    def step(self, op, *args):
        try:
            if op == "alloc":
                out = self.mgr.allocate_sequence(*args)
            elif op == "free":
                # a sequence the pool refused was never allocated
                out = self.mgr.free_sequence(*args) \
                    if args[0] in self.mgr.seq_blocks else "absent"
            else:
                out = self.mgr.append_token(*args)
        except self.mod.OutOfBlocksError:
            out = "oob"
        self.apply()
        self.log.append((op, out, self.mgr.get_stats(), self.mgr.spill_wire_stats()))


SCRIPT = [("alloc", "a", list(range(100, 113))), ("free", "a"),
          ("alloc", "b", list(range(200, 213))), ("free", "b"),
          ("alloc", "c", list(range(300, 321))), ("append", "c", 7), ("free", "c"),
          ("alloc", "d", list(range(400, 421))),
          ("alloc", "a2", list(range(100, 113))), ("free", "a2"), ("free", "d"),
          ("alloc", "b2", list(range(200, 214))), ("free", "b2"),
          ("alloc", "e", list(range(100, 110)) + [1, 2, 3, 4, 5, 6, 7])]

PLANS = {
    "none": [],
    "host-put-errors": [jfaults.FaultRule("io.spill.host.put", "error")],
    "remote-get-flaps": [jfaults.FaultRule("io.spill.remote.get", "flap", times=2)],
    "remote-corrupt": [jfaults.FaultRule("io.spill.remote.get", "corrupt", prob=0.5)],
    "pressure": [jfaults.FaultRule("kv.block.alloc", "pressure", after=5, times=1)],
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("host_blocks", [1, 64])
def test_manager_parity_with_the_jax_manager(plan, host_blocks, monkeypatch):
    monkeypatch.setenv("DGI_IO_BREAKER_THRESHOLD", "2")
    rules = PLANS[plan]
    trules = [tfaults.FaultRule(**{k: getattr(r, k) for k in (
        "site", "kind", "prob", "after", "times", "where", "status", "delay_s", "cut")})
        for r in rules]
    logs = []
    for mod, faults, rs, tensors in ((jkv, jfaults, rules, False),
                                     (tkv, tfaults, trules, True)):
        drv = _ManagerRun(mod, host_blocks, tensors)
        with faults.active(faults.FaultPlan(seed=11, rules=rs)) as fp:
            for step in SCRIPT:
                drv.step(*step)
        logs.append((drv.log, fp.trace, sorted(drv.remote._store)))
    assert logs[1] == logs[0]
    stats = logs[0][0][-1][2]
    assert stats["spills"] > 0 and stats["evictions"] > 0
    if plan == "none":
        assert stats["l2_hits" if host_blocks > 1 else "l3_hits"] > 0
    if plan == "host-put-errors":
        assert logs[0][0][-1][3]["breaker_host_trips"] >= 1


# ---------------------------------------------------------------- engine parity

MODEL = "llama3-tiny"
PROMPT_A = list(range(40, 88))              # 3 blocks; 2 restorable (one stays fresh)
FILLER = [7, 9] * 16


def _geom(kv):
    return dict(max_batch_size=1, max_seq_len=64, block_size=16,
                prefill_buckets=(16, 32, 64), num_blocks=8, dtype="float32",
                kv_cache_dtype=kv)


def _req(ds, p, n=8):
    return ds.InferenceRequest(prompt_token_ids=list(p),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0))


def _evict_a(eng, ds):
    for i in range(4):
        eng.generate([_req(ds, [(i * 3 + j) % 500 for j in FILLER])])


@pytest.fixture(scope="module")
def weights():
    cfg = get_model_config(MODEL, dtype="float32")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(5), jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module", params=["bf16", "int8"])
def jax_reference(request, weights):
    eng = jengine.TPUEngine(MODEL, jengine.EngineConfig(**_geom(request.param)),
                            params=weights[0])
    return request.param, eng.generate([_req(jds, PROMPT_A)])[0].token_ids


def _serve_restored(eng):
    """Admit A (its restored pages upload before the prefill of the rest)
    and decode to the end → the greedy ids."""
    slot = eng.submit(_req(tds, PROMPT_A))
    while eng.slots[slot] is not None and eng.slots[slot].finish_reason is None:
        eng.decode_step()
    return eng.finish_slot(slot).token_ids


@pytest.mark.parametrize("tier", ["L2", "L3"])
def test_restore_is_bitwise_and_the_stream_equals_the_jax_engine(weights, jax_reference, tier):
    kv, expect = jax_reference
    remote = tkv.RemoteKVStore()
    eng = tengine.TorchEngine(
        MODEL, tengine.EngineConfig(**_geom(kv), spill_host_blocks=64 if tier == "L2" else 1,
                                    spill_remote_store=remote),
        params=params_from_numpy(weights[1], "cpu"), device="cpu")
    spilled = {}
    real = eng.manager.store_spilled

    def record(key, page, scale=None):
        spilled[key] = (page.clone(), None if scale is None else scale.clone())
        real(key, page, scale)

    eng.manager.store_spilled = record
    real_pull = eng.pull_pages
    pulled = []

    def pull(bids):
        # the batched download against the pool pages it came from, read
        # by plain indexing
        out = real_pull(bids)
        for b, (page, scale) in zip(bids, out):
            direct = torch.stack((eng.kv["k"][:, b], eng.kv["v"][:, b]), 1)
            assert torch.equal(tensor_to_words_t(page), tensor_to_words_t(direct))
            if kv == "int8":
                sd = torch.stack((eng.kv["k_scale"][:, b], eng.kv["v_scale"][:, b]), 1)
                assert torch.equal(tensor_to_words_t(scale), tensor_to_words_t(sd))
        pulled.extend(bids)
        return out

    eng.pull_pages = pull
    first = eng.generate([_req(tds, PROMPT_A)])[0].token_ids
    assert first == expect
    blocks_a = [tds.compute_prefix_hash(PROMPT_A, (i + 1) * 16) for i in range(2)]
    _evict_a(eng, tds)
    assert eng.manager.get_stats()["spills"] >= 2 and set(blocks_a) <= set(spilled)
    assert len(pulled) >= 2
    pushed = []
    real_push = eng.push_pages

    def push(bids, pages, scales):
        real_push(bids, pages, scales)
        pushed.append((list(bids), eng.pull_pages(bids)))

    eng.push_pages = push
    before = eng.manager.get_stats()
    ids = _serve_restored(eng)
    st = eng.manager.get_stats()
    hits = (st["l2_hits"] - before["l2_hits"]) if tier == "L2" else \
        (st["l3_hits"] - before["l3_hits"])
    assert hits == 2
    (bids, restored), = pushed
    assert len(bids) == 2
    for key, (page, scale) in zip(blocks_a, restored):
        want_page, want_scale = spilled[key]
        assert torch.equal(tensor_to_words_t(page), tensor_to_words_t(want_page))
        if kv == "int8":
            assert torch.equal(tensor_to_words_t(scale), tensor_to_words_t(want_scale))
    assert ids == expect


def tensor_to_words_t(t):
    return torch.from_numpy(_bits(t).copy())


def test_spill_disabled_by_default(weights):
    eng = tengine.TorchEngine(MODEL, tengine.EngineConfig(**_geom(None)),
                              params=params_from_numpy(weights[1], "cpu"), device="cpu")
    eng.generate([_req(tds, PROMPT_A)])
    _evict_a(eng, tds)
    assert eng.manager.get_stats()["spills"] == 0 and eng.manager.host_store is None
    assert eng.manager.pending.empty
