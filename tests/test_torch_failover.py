"""Slot checkpoints that resume across both packages (CPU, f32,
``llama3-tiny``, the same weights on both sides): a checkpoint taken by the
JAX ``TPUEngine.snapshot_slot`` resumes in the port's ``_job_inference``,
one taken by ``TorchEngine.snapshot_slot`` resumes in the JAX engine and
the JAX worker, and a drain (``interrupt_live``) raises ``JobMigrated`` with
a checkpoint that resumes in either — each with greedy tokens identical to
an uninterrupted JAX run. A resume is a ragged admission, and a drain
that lands mid-prefill keeps its tokens. Also the edges: a complete checkpoint is served
without the engine, a corrupt one degrades to a fresh run, and
``checkpoint_live`` never checkpoints a slot reused by another request."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.base import JobMigrated  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import (  # noqa: E402
    ByteTokenizer,
    TorchLLMEngine,
)
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
GEOM = dict(max_batch_size=4, max_seq_len=128, prefill_buckets=(16, 32, 64),
            multi_step=8, dtype="float32")
COMMON = dict(model=MODEL, max_batch_size=4, max_seq_len=128,
              prefill_buckets=[16, 32, 64])
PROMPT = "drain me mid-batch"
NEW = 40
TIMEOUT = 60.0


def _params(**over):
    return dict({"prompt": PROMPT, "max_new_tokens": NEW, "ignore_eos": True}, **over)


def _req(ds, **kw):
    """The request either worker builds for ``_params()``."""
    return ds.InferenceRequest(
        prompt_token_ids=ByteTokenizer().encode(PROMPT),
        sampling=ds.SamplingParams(max_new_tokens=NEW, ignore_eos=True, **kw),
    )


def _recording(worker):
    seen = []
    real = worker.serving.submit

    def submit(req, *a, **kw):
        resp = real(req, *a, **kw)
        seen.append(list(resp.token_ids))
        return resp

    worker.serving.submit = submit
    return seen


def _wait_for(cond):
    deadline = time.time() + TIMEOUT
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(7),
                                 jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def jax_engine(weights):
    return jengine.TPUEngine(MODEL, jengine.EngineConfig(**GEOM), params=weights[0])


@pytest.fixture(scope="module")
def reference(jax_engine):
    """Greedy token ids of the uninterrupted JAX run."""
    ids = jax_engine.generate([_req(jds)])[0].token_ids
    assert len(ids) == NEW
    return list(ids)


@pytest.fixture(scope="module")
def jax_worker(weights):
    from distributed_gpu_inference_tpu.worker.engines import llm as jllm

    def f32_engine(name, eng_cfg, **kw):
        eng_cfg.dtype = "float32"
        return jengine.TPUEngine(name, eng_cfg, params=weights[0])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllm, "TPUEngine", f32_engine)
        jw = jllm.TPULLMEngine(dict(COMMON, prefix_summary_top_n=0))
        jw.load_model()
    yield jw
    jw.unload()


@pytest.fixture(scope="module")
def port(weights):
    tw = TorchLLMEngine(dict(COMMON, dtype="float32", device="cpu",
                             params=params_from_numpy(weights[1], "cpu"),
                             serving={"max_horizon": 4}))
    tw.load_model()
    yield tw
    tw.unload()


def _port_engine(weights):
    return tengine.TorchEngine(MODEL, tengine.EngineConfig(**GEOM),
                               params=params_from_numpy(weights[1], "cpu"),
                               device="cpu")


def _run_to_end(eng, slot):
    while eng.slots[slot].finish_reason is None:
        eng.decode_multi(4)
    return list(eng.finish_slot(slot).token_ids)


@pytest.mark.parametrize("k", [1, 9])
def test_jax_snapshot_resumes_in_the_port(jax_engine, port, reference, k):
    slot = jax_engine.submit(_req(jds))
    while len(jax_engine.slots[slot].generated) < k:
        jax_engine.decode_multi(1)
    wire = jax_engine.snapshot_slot(slot).to_wire()
    # the snapshot did not disturb the JAX slot
    assert _run_to_end(jax_engine, slot) == reference
    seen = _recording(port)
    try:
        out = port._job_inference(_params(), {"key": "j-jax", "epoch": 2,
                                               "checkpoint": wire})
    finally:
        del port.serving.submit
    assert seen == [reference]
    assert out["usage"]["completion_tokens"] == NEW
    assert out["text"] == ByteTokenizer().decode(reference)


@pytest.mark.parametrize("k", [1, 9])
def test_port_snapshot_resumes_in_jax(weights, jax_engine, jax_worker, reference, k):
    t = _port_engine(weights)
    slot = t.submit(_req(tds))
    while len(t.slots[slot].generated) < k:
        t.decode_multi(1)
    pre = t.snapshot_slot(slot)
    assert len(pre.generated) == k
    wire = pre.to_wire()
    assert _run_to_end(t, slot) == reference
    # the JAX engine continues it ...
    jslot = jax_engine.resume(jengine.PreemptedSequence.from_wire(wire))
    assert _run_to_end(jax_engine, jslot) == reference
    # ... and so does the JAX worker's failover path
    seen = _recording(jax_worker)
    try:
        out = jax_worker.inference(_params(_failover_ctx={
            "key": "j-port", "epoch": 3, "checkpoint": wire}))
    finally:
        del jax_worker.serving.submit
    assert seen == [reference]
    assert out["text"] == ByteTokenizer().decode(reference)


def _hold_after_first_tokens(monkeypatch, eng, n=5, then=None):
    """Make ``eng.decode_multi`` (the batcher's engine thread), once a live
    slot holds ``n`` tokens, call ``then()`` if given and wait before the
    next round until the returned event is set: the test acts on a
    generation that is surely mid-flight, however loaded the machine."""
    release = threading.Event()
    real = eng.decode_multi

    def held(*a, **kw):
        if any(s is not None and s.finish_reason is None and len(s.generated) >= n
               for s in eng.slots):
            if then is not None:
                then()
            release.wait(TIMEOUT)
        return real(*a, **kw)

    monkeypatch.setattr(eng, "decode_multi", held)
    return release


@pytest.mark.parametrize("resume_in", ["port", "jax"])
def test_drain_raises_job_migrated_with_a_resumable_checkpoint(
        port, jax_worker, reference, monkeypatch, resume_in):
    # the drain lands mid-generation, at the batcher's next step boundary
    release = _hold_after_first_tokens(monkeypatch, port.engine,
                                       then=port.interrupt_live)
    release.set()
    migrated = port.serving.get_stats()["migrated"]
    try:
        with pytest.raises(JobMigrated) as ei:
            port.inference(_params(_failover_ctx={"key": "jd", "epoch": 1,
                                                   "checkpoint": None}))
    finally:
        port._interrupt.clear()
        monkeypatch.undo()
    ck = ei.value.checkpoint
    assert ck["v"] == 1 and 0 < len(ck["generated"]) == ei.value.tokens < NEW
    assert port.serving.get_stats()["migrated"] == migrated + 1
    assert port.engine.num_active == 0 and port._live == {}
    worker = port if resume_in == "port" else jax_worker
    seen = _recording(worker)
    try:
        out = worker.inference(_params(_failover_ctx={"key": "jd2", "epoch": 2,
                                                       "checkpoint": ck}))
    finally:
        del worker.serving.submit
    assert seen == [reference]
    assert out["usage"]["completion_tokens"] == NEW


def test_resume_rides_a_ragged_round_and_a_drain_mid_prefill_keeps_its_tokens(
        weights, port, reference, monkeypatch):
    # a resume is admitted as a ragged admission: its recompute rides the
    # next ragged round as a prompt does
    t = _port_engine(weights)
    slot = t.submit(_req(tds))
    while len(t.slots[slot].generated) < 9:
        t.decode_multi(1)
    wire = t.snapshot_slot(slot).to_wire()
    ragged = port.serving.get_stats()["ragged_admissions"]
    seen = _recording(port)
    try:
        port._job_inference(_params(), {"key": "rr", "checkpoint": wire})
    finally:
        del port.serving.submit
    assert seen == [reference]
    assert port.serving.get_stats()["ragged_admissions"] == ragged + 1
    # a drain that lands while the resume is still mid-prefill (its round
    # gave it no chunk) hands back the checkpoint's tokens, not a fresh
    # zero-token checkpoint
    eng = port.engine

    def chunkless_round(adms, caps=None):
        port.interrupt_live()
        return {}

    monkeypatch.setattr(eng, "ragged_round", chunkless_round)
    try:
        with pytest.raises(JobMigrated) as ei:
            port._job_inference(_params(), {"key": "rr2", "checkpoint": wire})
    finally:
        port._interrupt.clear()
        monkeypatch.undo()
    assert ei.value.checkpoint["generated"] == reference[:9] == wire["generated"]
    assert eng.num_active == 0 and port._live == {}


def test_complete_checkpoint_is_delivered_without_the_engine(weights, port, reference):
    t = _port_engine(weights)
    slot = t.submit(_req(tds))
    while len(t.slots[slot].generated) < NEW - 1:
        t.decode_multi(1)
    pre = t.snapshot_slot(slot)
    pre.generated = list(reference)     # as if the donor died after its last step
    wire = pre.to_wire()
    submitted = port.serving.get_stats()["submitted"]
    out = port._job_inference(_params(), {"key": "done", "checkpoint": wire})
    assert out["text"] == ByteTokenizer().decode(reference)
    assert out["finish_reason"] == "length"
    assert out["usage"]["completion_tokens"] == NEW
    # a stream resumed at offset 30 gets the other 10 tokens and the finish
    chunks = list(port.stream(_params(_failover_ctx={
        "key": "s-done", "checkpoint": wire, "offset": 30})))
    assert [t for c in chunks[:-1] for t in c["token_ids"]] == reference[30:]
    assert chunks[-1]["done"] and chunks[-1]["offset"] == NEW
    assert port.serving.get_stats()["submitted"] == submitted


def test_corrupt_checkpoint_degrades_to_a_fresh_run(weights, port, reference):
    t = _port_engine(weights)
    slot = t.submit(_req(tds))
    wire = t.snapshot_slot(slot).to_wire()
    wire["generated"] = [7, 7, 7]        # crc no longer matches
    before = port.ckpt_corrupt
    seen = _recording(port)
    try:
        port._job_inference(_params(), {"key": "bad", "checkpoint": wire})
    finally:
        del port.serving.submit
    assert port.ckpt_corrupt == before + 1
    assert seen == [reference]


def test_checkpoint_live_skips_a_slot_reused_by_another_request(port, monkeypatch):
    release = _hold_after_first_tokens(monkeypatch, port.engine)
    done = {}
    t = threading.Thread(target=lambda: done.update(out=port._job_inference(
        _params(), {"key": "live-1", "epoch": 4, "checkpoint": None})))
    t.start()
    try:
        assert _wait_for(lambda: any(s is not None and len(s.generated) >= 5
                                     for s in port.engine.slots))
        entries = port.checkpoint_live()
        assert len(entries) == 1
        e = entries[0]
        assert (e["kind"], e["key"], e["epoch"]) == ("job", "live-1", 4)
        rid = port._live["live-1"]["request_id"]
        assert e["state"]["request"]["request_id"] == rid
        assert len(e["state"]["generated"]) >= 5
        # the slot is freed and taken by another request between the scan
        # and the snapshot: that sequence is never checkpointed under this key
        real_snap = port.engine.snapshot_slot

        def reused(slot):
            pre = real_snap(slot)
            pre.request = tds.InferenceRequest(request_id="someone-else",
                                               prompt_token_ids=[5])
            return pre

        monkeypatch.setattr(port.engine, "snapshot_slot", reused)
        assert port.checkpoint_live() == []
        # a live key whose request holds no slot is skipped too
        port._register_live("ghost", "job", 0, "no-such-request")
        monkeypatch.setattr(port.engine, "snapshot_slot", real_snap)
        assert [x["key"] for x in port.checkpoint_live()] == ["live-1"]
    finally:
        port._unregister_live("ghost")
        release.set()
        t.join(TIMEOUT)
    assert not t.is_alive() and done["out"]["usage"]["completion_tokens"] == NEW
    assert port.checkpoint_live() == []


def test_snapshot_slot_refuses_empty_prefilling_and_finished_slots(weights, reference):
    t = _port_engine(weights)
    with pytest.raises(ValueError, match="empty"):
        t.snapshot_slot(0)
    adm = t.submit_chunked_start(_req(tds))
    with pytest.raises(ValueError, match="mid-prefill"):
        t.snapshot_slot(adm.slot)
    while not adm.done:
        t.submit_chunked_step(adm)
    pre = t.snapshot_slot(adm.slot)
    assert pre.generated == t.slots[adm.slot].generated == reference[:1]
    while t.slots[adm.slot].finish_reason is None:
        t.decode_multi(8)
    with pytest.raises(ValueError, match="finished"):
        t.snapshot_slot(adm.slot)
    assert list(t.finish_slot(adm.slot).token_ids) == reference
