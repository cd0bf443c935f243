"""The port's RESP2 L3 tier (``runtime/redis_kv.py``) over a loopback RESP
stand-in (``tests/test_redis_kv.py`` ``FakeRedisServer``): round trip,
TTL, bounded async writeback, fail-open, latency backoff, the
``io.spill.redis.*`` seams, ``remote_store_from_url`` — and a JAX engine and
the port's engine sharing one store, restoring each other's spilled pages
exactly when their pool dtypes match (CPU, ``llama3-tiny``)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_redis_kv import FakeRedisServer  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import redis_kv as tredis  # noqa: E402
from distributed_gpu_inference_torch.runtime.kv_cache import RemoteKVStore  # noqa: E402
from distributed_gpu_inference_torch.testing import faults as tfaults  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import redis_kv as jredis  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402


@pytest.fixture()
def server():
    s = FakeRedisServer()
    yield s
    s.close()


def _store(server, **kw):
    return tredis.RedisKVStore(host="127.0.0.1", port=server.port,
                               writeback_queue=32, **kw)


def test_put_get_roundtrip_and_wire_commands(server):
    st = _store(server, ttl_s=7.0, key_prefix="p:")
    try:
        assert st.ping()
        st.put("page-1", b"\x00\x01payload")
        assert st.flush()
        assert st.get("page-1") == b"\x00\x01payload"
        assert st.get("missing") is None
        assert st.stats["hits"] == 1 and st.stats["gets"] == 2
        sets = [c for c in server.commands if c[0] == b"SET"]
        assert sets == [[b"SET", b"p:page-1", b"\x00\x01payload", b"PX", b"7000"]]
        st.delete("page-1")                  # a tombstone on the writeback queue
        assert st.flush()
        assert st.get("page-1") is None and [b"DEL", b"p:page-1"] in server.commands
    finally:
        st.close()


def test_the_same_keys_and_bytes_as_the_jax_client(server):
    mine, theirs = _store(server), jredis.RedisKVStore(host="127.0.0.1", port=server.port)
    try:
        mine.put("a", b"from the port")
        theirs.put("b", b"from jax")
        assert mine.flush() and theirs.flush()
        assert theirs.get("a") == b"from the port" and mine.get("b") == b"from jax"
    finally:
        mine.close()
        theirs.close()


def test_writeback_is_async_and_bounded(server):
    st = _store(server)
    try:
        for i in range(100):   # queue bound 32: the oldest writes drop
            st.put(f"k{i}", b"x" * 10)
        assert st.stats["puts"] == 100
        st.flush()
        assert st.stats["dropped"] > 0
        assert st.get("k99") == b"x" * 10     # the newest write survives
    finally:
        st.close()


def test_fail_open_when_server_down():
    st = tredis.RedisKVStore(host="127.0.0.1", port=1, reconnect_backoff_s=0.05,
                             writeback_queue=4)
    try:
        assert st.get("k") is None          # a miss, no exception
        st.put("k", b"v")                   # swallowed
        assert not st.ping()
        assert st.stats["errors"] > 0
    finally:
        st.close()


def test_slow_server_trips_latency_backoff(server):
    st = _store(server, probe_timeout_s=0.05, timeout_s=2.0, reconnect_backoff_s=0.4)
    try:
        st.put("k", b"v")
        assert st.flush()
        server.get_delay = 0.3
        t0 = time.monotonic()
        assert st.get("k") is None           # deadline breach → miss
        assert time.monotonic() - t0 < 0.4   # bounded by the probe, not 2 s
        assert st.stats["slow_trips"] == 1
        n_cmds = len(server.commands)
        assert st.get("k") is None           # inside the backoff: socket untouched
        assert len(server.commands) == n_cmds
        server.get_delay = 0.0
        time.sleep(0.45)
        assert st.get("k") == b"v"
    finally:
        st.close()


def test_redis_seams_take_the_outage_path(server):
    st = _store(server, reconnect_backoff_s=0.05)
    try:
        st.put("k", b"v")
        assert st.flush()
        rules = [tfaults.FaultRule("io.spill.redis.get", "error", times=1),
                 tfaults.FaultRule("io.spill.redis.put", "error", times=1)]
        with tfaults.active(tfaults.FaultPlan(seed=3, rules=rules)) as plan:
            assert st.get("k") is None            # injected error → fail-open miss
            errors = st.stats["errors"]
            assert errors >= 1
            st.put("k2", b"w")                    # first SET fails, the retry lands
            assert st.flush(timeout_s=3.0)
            assert st.stats["errors"] == errors + 1
            time.sleep(0.06)                      # past the get backoff
            assert st.get("k2") == b"w"
        assert [(site, kind) for site, kind, _ in plan.trace] == [
            ("io.spill.redis.get", "error"), ("io.spill.redis.put", "error")]
    finally:
        st.close()


def test_remote_store_from_url(server):
    st = tredis.remote_store_from_url(f"redis://127.0.0.1:{server.port}/2", ttl_s=5.0)
    try:
        assert isinstance(st, tredis.RedisKVStore) and st.ttl_s == 5.0
        assert st.ping()
        assert [b"SELECT", b"2"] in server.commands
    finally:
        st.close()
    mem = tredis.remote_store_from_url("memory://")
    assert isinstance(mem, RemoteKVStore)
    mem.put("k", b"v")
    assert mem.get("k") == b"v"
    assert tredis.remote_store_from_url(None) is None
    with pytest.raises(ValueError):
        tredis.remote_store_from_url("s3://bucket")


# ---------------------------------------------------------------- two packages, one store

MODEL = "llama3-tiny"
PROMPT_A = list(range(40, 88))
FILLER = [7, 9] * 16


def _geom(kv, store):
    return dict(max_batch_size=1, max_seq_len=64, block_size=16,
                prefill_buckets=(16, 32, 64), num_blocks=8, dtype="float32",
                kv_cache_dtype=kv, spill_remote_store=store)


def _req(ds, p, n=8):
    return ds.InferenceRequest(prompt_token_ids=list(p),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0))


def _serve(eng, ds, prompt=PROMPT_A):
    return eng.generate([_req(ds, prompt)])[0].token_ids


def _evict_a(eng, ds, store):
    for i in range(4):
        _serve(eng, ds, [(i * 3 + j) % 500 for j in FILLER])
    assert store.flush()


def _l3(eng):
    return eng.manager.get_stats()["l3_hits"]


def test_jax_and_port_engines_share_one_store_by_dtype(server):
    jparams = jllama.init_params(get_model_config(MODEL, dtype="float32"),
                                 jax.random.PRNGKey(9), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    stores = []

    def store(mod):
        stores.append(mod.RedisKVStore(host="127.0.0.1", port=server.port))
        return stores[-1]

    try:
        # JAX spills A from a bf16 pool (zstd frames) ...
        jb_store = store(jredis)
        jb = jengine.TPUEngine(MODEL, jengine.EngineConfig(**_geom("bf16", jb_store)),
                               params=jparams)
        expect_bf16 = _serve(jb, jds)
        _evict_a(jb, jds, jb_store)
        # ... a port bf16 pool restores both of A's restorable blocks
        tb = tengine.TorchEngine(MODEL, tengine.EngineConfig(**_geom("bf16", store(tredis))),
                                 params=tparams, device="cpu")
        assert _serve(tb, tds) == expect_bf16 and _l3(tb) == 2
        # a port int8 pool must not take bf16 entries: a miss, recomputed
        ti_store = store(tredis)
        ti = tengine.TorchEngine(MODEL, tengine.EngineConfig(**_geom("int8", ti_store)),
                                 params=tparams, device="cpu")
        ids_int8 = _serve(ti, tds)
        assert _l3(ti) == 0
        # the port spills A from its int8 pool; a JAX int8 pool restores it
        _evict_a(ti, tds, ti_store)
        ji = jengine.TPUEngine(MODEL, jengine.EngineConfig(**_geom("int8", store(jredis))),
                               params=jparams)
        assert _serve(ji, jds) == ids_int8 and _l3(ji) == 2
        # and the bf16 pools now miss the int8 entries
        tb.manager.clear_cached(spill=False)
        assert _serve(tb, tds) == expect_bf16 and _l3(tb) == 2
    finally:
        for st in stores:
            st.close()
