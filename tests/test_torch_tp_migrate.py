"""Prefix migration and device moves under tensor parallelism (CPU, f32,
``llama3-tiny`` weights shared with the JAX package through
``models/convert.py``, gloo ranks):

- a tp-2 port worker on a default config has ``kv_migrate`` on, as the JAX
  worker has, and serves ``/kv/export`` over its data plane: the frames are
  byte-identical to a one-device engine's ``export_prefix_frames`` of the
  same prefix on int8 pools; on f32 pools the begin and commit frames are,
  and the pieces' pages agree to 1e-5 (the tp-2 rows are a last bit apart
  where a row-parallel sum added the ranks' partial products in another
  order), as the JAX engine's on a model-2 mesh agree with its one-device
  engine's and no closer;
- a tp-2 worker pulls a prefix from a tp-2 peer and serves the same greedy
  stream, the adopted pages written to each rank's heads;
- ``migrate_kv_device`` between two tp-2 engines on the same devices moves
  pages and int8 scales bit for bit, and the recipient continues the
  donor's greedy stream; the JAX package's engine gives the same ids."""

import dataclasses
import http.client
import urllib.parse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer  # noqa: E402
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    params_from_numpy,
    tensor_to_words,
)
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import kv_handoff as tkh  # noqa: E402
from distributed_gpu_inference_torch.runtime import tp as tp_ranks  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.parallel.mesh import MeshPlan as JMeshPlan  # noqa: E402
from distributed_gpu_inference_tpu.parallel.mesh import make_mesh  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import kv_handoff as jkh  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
CPU2 = ["cpu", "cpu"]
GEOM = dict(max_batch_size=2, max_seq_len=256, multi_step=4, dtype="float32")
PROMPT = [int(t) for t in np.random.default_rng(31).integers(1, 500, 100)]   # 6 full blocks
SYSTEM = "s" * 128                       # 8 KV blocks, 2 fingerprint blocks


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _short_timeout():
    was = tp_ranks.TIMEOUT_S
    tp_ranks.TIMEOUT_S = 30.0
    yield
    tp_ranks.TIMEOUT_S = was


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(3), jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _req(ds, prompt=PROMPT, n=8):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0))


def _worker(weights, tp, **kw):
    """A port LLM worker on the default config (no ``kv_migrate`` key) and
    its data plane."""
    llm = TorchLLMEngine(dict(GEOM, model=MODEL, device="cpu",
                              params=params_from_numpy(weights[1], "cpu"),
                              serving={"queue_limit": 64, "default_timeout_s": 60.0},
                              extra={"tp_size": tp}, **kw))
    llm.load_model()
    plane = DataPlaneServer(kv_receiver=llm.kv_receiver, kv_exporter=llm.kv_export)
    plane.start()
    return llm, plane


def _post(url, path, body):
    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


@pytest.mark.parametrize("kv", [None, "int8"])
def test_tp2_worker_serves_kv_export_like_one_device(weights, kv):
    llm, plane = _worker(weights, 2, kv_cache_dtype=kv)
    try:
        assert llm.kv_migrate_enabled and llm.engine.tp == 2
        eng = llm.engine
        llm._exclusive(lambda: eng.generate([_req(tds)]))
        one = tengine.TorchEngine(MODEL, dataclasses.replace(eng.cfg),
                                  params=params_from_numpy(weights[1], "cpu"), device="cpu")
        one.generate([_req(tds)])
        want, info = tkh.export_prefix_frames(one, PROMPT, "tp-pull")
        assert info == {"dev_blocks": 6, "spill_blocks": 0}
        before = eng.get_stats()["tp"]["all_gather"]
        status, body = _post(plane.url, "/kv/export", tkh.pack_export_request(
            key="tp-pull", token_ids=PROMPT, model_name=MODEL, block_size=16,
            int8_kv=kv == "int8"))
        assert status == 200
        got = tkh.split_frames(body)
        assert eng.get_stats()["tp"]["all_gather"] > before   # the heads met on rank 0
        assert [tkh.message_kind(f) for f in got] == [tkh.message_kind(f) for f in want]
        assert llm.kv_migrate_stats["exports"] == 1
        if kv == "int8":
            assert got == want
            return
        assert got[0] == want[0] and got[-1] == want[-1]
        port_diff = _assert_pages_close(got, want)
        # the JAX engine on a model-2 mesh stands to its one-device engine
        # as the port's does: the same frames but for the pages' last bits
        jone = jengine.TPUEngine(MODEL, jengine.EngineConfig(**GEOM), params=weights[0])
        jone.generate([_req(jds)])
        jtp = jengine.TPUEngine(MODEL, jengine.EngineConfig(**GEOM), params=weights[0],
                                mesh=make_mesh(JMeshPlan(model=2), jax.devices()[:2],
                                               keep_trivial_axes=False))
        jtp.generate([_req(jds)])
        jwant, _ = jkh.export_prefix_frames(jone, PROMPT, "tp-pull")
        jgot, _ = jkh.export_prefix_frames(jtp, PROMPT, "tp-pull")
        assert jgot[0] == jwant[0] and jgot[-1] == jwant[-1]
        jax_diff = _assert_pages_close(jgot, jwant)
        assert jgot != jwant      # byte identity on f32 pools is no JAX property either
        print(f"f32 pages, tp 2 against one device (largest difference, bytes that "
              f"differ): port {port_diff}, JAX {jax_diff}")
    finally:
        plane.stop()
        llm.unload()


def test_tp2_worker_pulls_a_prefix_and_serves_the_same_stream(weights):
    warm, warm_plane = _worker(weights, 2)
    cold, cold_plane = _worker(weights, 2)
    try:
        prompt = SYSTEM + "q" * 24
        ref = warm.inference({"prompt": prompt, "max_new_tokens": 12})
        hint = {"worker_id": "warm", "data_plane_url": warm_plane.url, "matched_blocks": 2,
                "tier": "dev"}
        pushed = cold.engine.get_stats()["tp"]["broadcast"]
        out = cold.inference({"prompt": prompt, "max_new_tokens": 12,
                              "kv_migrate_from": dict(hint)})
        assert out["text"] == ref["text"] and out["usage"]["cached_tokens"] >= 128
        st = cold.kv_migrate_stats
        assert st["pulled"] == 1 and st["pull_blocks"] >= 8 and st["pull_bytes"] > 0
        assert warm.kv_migrate_stats["exports"] == 1
        assert cold.kv_migrate_wire_stats()["prefix_commits"] == 1
        # the adopted pages were pushed to the rank, which wrote its heads
        assert cold.engine.get_stats()["tp"]["broadcast"] > pushed
        # a one-device worker serves the same text without a pull
        one, one_plane = _worker(weights, 1)
        try:
            assert one.inference({"prompt": prompt, "max_new_tokens": 12})["text"] == \
                ref["text"]
        finally:
            one_plane.stop()
            one.unload()
    finally:
        for llm, plane in ((warm, warm_plane), (cold, cold_plane)):
            plane.stop()
            llm.unload()


def _assert_pages_close(got, want):
    """The piece frames of two exports: equal headers, pages within 1e-5.
    → (the largest page difference, the page bytes that differ)."""
    worst, n_bytes = 0.0, 0
    for g, w in zip(got[1:-1], want[1:-1]):
        (gk, gm, gp), (wk, wm, wp) = tkh._unpack_stream(g), tkh._unpack_stream(w)
        assert gk == wk and gm == wm and len(gp) == len(wp)
        a, b = tkh._read_pages(gp, None)[0].numpy(), tkh._read_pages(wp, None)[0].numpy()
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        worst = max(worst, float(np.abs(a - b).max()))
        n_bytes += int((np.frombuffer(gp, np.uint8) != np.frombuffer(wp, np.uint8)).sum())
    return worst, n_bytes


def _finish(eng, slot):
    while eng.slots[slot].finish_reason is None:
        eng.decode_multi()
    return list(eng.finish_slot(slot).token_ids)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_migrate_kv_device_between_tp2_engines_is_bitwise(weights, kv):
    def port():
        return tengine.TorchEngine(MODEL, tengine.EngineConfig(
            **GEOM, prefill_buckets=(16, 32), kv_cache_dtype=kv),
            params=params_from_numpy(weights[1], "cpu"), rank_devices=CPU2)

    src, dst = port(), port()
    try:
        want = list(jengine.TPUEngine(MODEL, jengine.EngineConfig(
            **GEOM, prefill_buckets=(16, 32), kv_cache_dtype=kv),
            params=weights[0]).generate([_req(jds)])[0].token_ids)
        slot = src.submit(_req(tds))
        src.decode_multi()                    # a few tokens in, mid-stream
        blocks = list(src.manager.seq_blocks[src.slots[slot].seq_id])
        dslot = tkh.migrate_kv_device(src, dst, slot)
        moved = list(dst.manager.seq_blocks[dst.slots[dslot].seq_id])
        a, b = src.gather_pages(blocks), dst.gather_pages(moved)
        np.testing.assert_array_equal(tensor_to_words(a.pages), tensor_to_words(b.pages))
        if kv == "int8":
            np.testing.assert_array_equal(tensor_to_words(a.scales),
                                          tensor_to_words(b.scales))
        # each rank's pools hold the same bits at the moved blocks
        names = ("k", "v") + (("k_scale", "v_scale") if kv else ())
        for rs, rd in zip(src.rank_pools(names), dst.rank_pools(names)):
            for k in names:
                np.testing.assert_array_equal(rs[k][:, blocks], rd[k][:, moved])
        # both continue the stream the JAX engine generates
        assert _finish(dst, dslot) == want
        assert _finish(src, slot) == want
    finally:
        src.shutdown()
        dst.shutdown()
