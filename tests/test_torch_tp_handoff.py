"""Page transfers across ranks in the PyTorch port (CPU, f32, gloo ranks,
``llama3-tiny`` weights shared with the JAX package through
``models/convert.py``): ``gather_pages`` / ``push_pages`` under tp 2 and
seq 2 give the single-device page layout, so

- a ``kv_seq_sharded`` seq-2 donor streams a long prompt into a tp-2
  recipient (``StreamedExport`` → ``HandoffReceiver``), and a tp-2 engine's
  one-shot export adopts into the seq-sharded engine and into the JAX
  single-chip engine: each continues identically to the JAX single-chip
  engine (the port of JAX ``tests/test_kv_handoff_stream.py``'s combined
  regime), for f32 and int8 pools;
- the wire is byte-identical to JAX's ``serialize_handoff`` of the same
  pages;
- a tp-2 ``gather_pages`` equals a one-device engine's after the same
  page pushes, bit for bit;
- PD (prefill → decode over a ``DataPlaneServer``) and the spill tiers
  (L2 and L3, through the engine and through the worker's keys) serve
  under ``tp_size: 2``;
- ``migrate_kv_device`` between a mesh engine and an engine on other
  devices stays refused, before any device work; ``kv_migrate`` loads at
  tp 2."""

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
from distributed_gpu_inference_torch.parallel.mesh import MeshPlan  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import kv_cache as tkv  # noqa: E402
from distributed_gpu_inference_torch.runtime import kv_handoff as tkh  # noqa: E402
from distributed_gpu_inference_torch.runtime import tp as tp_ranks  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import kv_handoff as jkh  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
CPU2 = ["cpu", "cpu"]
NEW = 8
LONG = [int(t) for t in np.random.default_rng(21).integers(1, 500, 70)]   # 5 blocks


def _geom(**kw):
    base = dict(max_batch_size=2, max_seq_len=256, block_size=16, prefill_buckets=(16,),
                multi_step=4, dtype="float32", enable_prefix_cache=False)
    base.update(kw)
    return base


def _req(ds, prompt=LONG, n=NEW):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0))


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


def _jax(weights, **kw):
    return jengine.TPUEngine(MODEL, jengine.EngineConfig(**_geom(**kw)), params=weights[0])


def _port(weights, **kw):
    mesh = kw.pop("mesh", None)
    devices = kw.pop("rank_devices", None)
    return tengine.TorchEngine(MODEL, tengine.EngineConfig(**_geom(**kw)),
                               params=params_from_numpy(weights[1], "cpu"), device="cpu",
                               rank_devices=devices, mesh=mesh)


@pytest.fixture(scope="module")
def reference(weights):
    """Greedy ids of uninterrupted JAX single-chip runs, by KV pool."""
    return {kv: list(_jax(weights, kv_cache_dtype=kv).generate([_req(jds)])[0].token_ids)
            for kv in (None, "int8")}


def _finish(eng, slot):
    while eng.slots[slot].finish_reason is None:
        eng.decode_multi()
    return list(eng.finish_slot(slot).token_ids)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_seq_sharded_donor_streams_into_a_tp2_recipient(weights, reference, kv):
    pre = _port(weights, kv_cache_dtype=kv, kv_seq_sharded=True, rank_devices=CPU2,
                mesh=MeshPlan(seq=2))
    dec = _port(weights, kv_cache_dtype=kv, rank_devices=CPU2)
    try:
        rx = tkh.HandoffReceiver(dec)
        exp = tkh.StreamedExport(pre, _req(tds), key="combo", piece_blocks=2)
        result = None
        for msg in exp.messages():
            result = rx.handle(msg)
        assert result["state"] == "committed"
        assert exp.bytes_before_first_token > 0
        assert pre.get_stats()["seq"]["all_gather"] > 0       # pieces crossed ranks
        assert _finish(dec, result["slot"]) == reference[kv]
        # and back: a tp-2 one-shot export adopts into the seq-sharded engine
        # and into the JAX single-chip engine, both continuing the stream
        slot = dec.submit(_req(tds))
        h = tkh.export_slot_kv(dec, slot)
        dec.finish_slot(slot, cache=False)
        raw = tkh.serialize_handoff(h)
        assert _finish(pre, tkh.adopt_kv(pre, tkh.deserialize_handoff(raw))) == reference[kv]
        jh = jkh.deserialize_handoff(raw)
        assert jkh.serialize_handoff(jh, compress=False) == raw
        j = _jax(weights, kv_cache_dtype=kv)
        assert list(_jfinish(j, jkh.adopt_kv(j, jh))) == reference[kv]
    finally:
        pre.shutdown()
        dec.shutdown()


def _jfinish(eng, slot):
    while eng.slots[slot].finish_reason is None:
        eng.decode_step()
    return eng.finish_slot(slot).token_ids


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("axis", ["model", "seq"])
def test_gather_and_push_give_the_one_device_layout(weights, kv, axis):
    """Pages pushed into a mesh engine come back out of ``gather_pages``
    bit for bit, and a one-device engine holds the same bits at the same
    global blocks."""
    mesh = MeshPlan(seq=2) if axis == "seq" else MeshPlan(model=2)
    eng = _port(weights, kv_cache_dtype=kv, kv_seq_sharded=axis == "seq", rank_devices=CPU2,
                mesh=mesh, num_blocks=12)
    one = _port(weights, kv_cache_dtype=kv, num_blocks=12)
    try:
        shape, _, sshape, _ = one._page_layout()
        assert eng._page_layout()[0] == shape and eng.manager.page_shape == shape
        rng = np.random.default_rng(5)
        bids = [2, 9, 5, 11]          # both halves of a sharded pool
        if kv == "int8":
            pages = [torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
                     for _ in bids]
            scales = [torch.tensor(rng.uniform(0.01, 0.02, sshape), dtype=torch.bfloat16)
                      for _ in bids]
        else:
            pages = [torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
                     for _ in bids]
            scales = [None] * len(bids)
        for e in (eng, one):
            e.push_pages(bids, pages, scales)
        got, want = eng.gather_pages(bids), one.gather_pages(bids)
        np.testing.assert_array_equal(tensor_to_words(got.pages), tensor_to_words(want.pages))
        for i, p in enumerate(pages):
            np.testing.assert_array_equal(tensor_to_words(got.pages[i]), tensor_to_words(p))
        if kv == "int8":
            np.testing.assert_array_equal(tensor_to_words(got.scales),
                                          tensor_to_words(want.scales))
        # a copy-on-write page copy across ranks (block 2 on rank 0, 9 on rank 1)
        eng.manager.pending.copies.append((2, 8))
        one.manager.pending.copies.append((2, 8))
        eng._apply_pending()
        one._apply_pending()
        np.testing.assert_array_equal(tensor_to_words(eng.gather_pages([8]).pages),
                                      tensor_to_words(one.gather_pages([8]).pages))
    finally:
        eng.shutdown()


# -- the spill tiers under tp 2 ----------------------------------------------------

PROMPT_A = list(range(40, 88))          # 3 blocks; 2 restorable
FILLER = [7, 9] * 16


@pytest.mark.parametrize("tier", ["L2", "L3"])
def test_spill_and_restore_under_tp2(weights, tier):
    geom = dict(max_batch_size=1, max_seq_len=64, prefill_buckets=(16, 32, 64), num_blocks=8,
                enable_prefix_cache=True)
    want = list(_jax(weights, **geom).generate([_req(jds, PROMPT_A)])[0].token_ids)
    eng = _port(weights, **geom, rank_devices=CPU2,
                spill_host_blocks=64 if tier == "L2" else 1,
                spill_remote_store=tkv.RemoteKVStore())
    try:
        assert eng.generate([_req(tds, PROMPT_A)])[0].token_ids == want
        spilled = {}
        real = eng.manager.store_spilled

        def record(key, page, scale=None):
            spilled[key] = page.clone()
            real(key, page, scale)

        eng.manager.store_spilled = record
        for i in range(4):
            eng.generate([_req(tds, [(i * 3 + j) % 500 for j in FILLER])])
        assert eng.manager.get_stats()["spills"] >= 2 and spilled
        before = eng.manager.get_stats()
        slot = eng.submit(_req(tds, PROMPT_A))
        st = eng.manager.get_stats()
        hits = st["l2_hits" if tier == "L2" else "l3_hits"] - \
            before["l2_hits" if tier == "L2" else "l3_hits"]
        assert hits == 2
        blocks_a = [tds.compute_prefix_hash(PROMPT_A, (i + 1) * 16) for i in range(2)]
        restored = eng.gather_pages(eng.manager.seq_blocks[eng.slots[slot].seq_id][:2])
        for i, key in enumerate(blocks_a):
            np.testing.assert_array_equal(tensor_to_words(restored.pages[i]),
                                          tensor_to_words(spilled[key]))
        assert _finish(eng, slot) == want
    finally:
        eng.shutdown()


@pytest.mark.parametrize("key,value", [("kv_spill_host_blocks", 16),
                                       ("kv_remote_url", "memory://")])
def test_the_worker_serves_spill_tiers_at_tp_size_2(weights, key, value):
    outs = []
    for tp in (1, 2):
        llm = TorchLLMEngine({"model": MODEL, "device": "cpu", "dtype": "float32",
                              "max_seq_len": 128, "prefill_buckets": [16, 32, 64],
                              "params": params_from_numpy(weights[1], "cpu"),
                              "tp_size": tp, key: value})
        llm.load_model()
        try:
            assert llm.engine.tp == tp
            assert (llm.engine.manager.host_store is not None) == (key == "kv_spill_host_blocks")
            outs.append([llm.inference({"prompt": p, "max_new_tokens": 6,
                                        "ignore_eos": True})["text"]
                         for p in ("hello there", "spill tiers on two ranks")])
        finally:
            llm.unload()
    assert outs[1] == outs[0]


# -- PD under tp 2 through the worker's engine ---------------------------------------


@pytest.mark.parametrize("stream", [True, False])
def test_pd_prefill_to_decode_under_tp_size_2(weights, stream):
    def llm(tp):
        e = TorchLLMEngine({"model": MODEL, "device": "cpu", "dtype": "float32",
                            "max_seq_len": 128, "prefill_buckets": [16, 32, 64],
                            "params": params_from_numpy(weights[1], "cpu"),
                            "extra": {"tp_size": tp}})
        e.load_model()
        return e

    ref = llm(1)
    try:
        want = ref.inference({"prompt": "disaggregated prefill", "max_new_tokens": 8,
                              "ignore_eos": True})
    finally:
        ref.unload()
    pre, dec = llm(2), llm(2)
    plane = DataPlaneServer(kv_receiver=dec.kv_receiver)
    plane.start()
    try:
        job = {"prompt": "disaggregated prefill", "max_new_tokens": 8, "ignore_eos": True,
               "decode_url": plane.url, "decode_worker": "w2", "target_worker": "w1",
               "kv_cache_key": "pd-tp2", "pd_stream": stream}
        out = pre.pd_prefill(job)
        assert not out.get("local")
        assert pre.engine.get_stats()["tp"]["all_gather"] > 0
        got = dec.pd_decode({"kv_cache_key": "pd-tp2"})
        assert got["text"] == want["text"]
        assert dec.engine.get_stats()["tp"]["broadcast"] > 0     # pushed pages crossed
    finally:
        plane.stop()
        pre.unload()
        dec.unload()


# -- what stays refused -----------------------------------------------------------


def test_device_migration_and_kv_migrate_stay_refused_on_a_mesh(weights):
    """Since the mesh engines' device moves and the worker's ``kv_migrate``
    serve under TP (``tests/test_torch_tp_migrate.py``), what stays refused
    is a device move between a mesh engine and an engine on other devices,
    before any device work; ``kv_migrate: true`` now loads at tp 2."""
    eng = _port(weights, rank_devices=CPU2)
    seq = _port(weights, rank_devices=CPU2, mesh=MeshPlan(seq=2))
    other = _port(weights)
    other.rank_devices = [torch.device("cuda", 1)]      # an engine on another card
    try:
        slot = eng.submit(_req(tds, LONG[:20], 4))
        before = eng.get_stats()["tp"]["all_gather"]
        for src, dst in ((eng, other), (other, seq)):
            s = slot if src is eng else other.submit(_req(tds, LONG[:20], 4))
            with pytest.raises(NotImplementedError, match="on different devices"):
                tkh.migrate_kv_device(src, dst, s)
        assert eng.get_stats()["tp"]["all_gather"] == before
    finally:
        eng.shutdown()
        seq.shutdown()
    llm = TorchLLMEngine({"model": MODEL, "device": "cpu", "tp_size": 2, "kv_migrate": True})
    try:
        llm.load_model()
        assert llm.kv_migrate_enabled and llm.engine.tp == 2
    finally:
        llm.unload()
