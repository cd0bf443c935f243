"""``serving.mode: direct`` in the port: ``TorchLLMEngine`` with no batcher,
held to the JAX worker engine in direct mode (``TPULLMEngine``) on the same
``llama3-tiny`` weights in f32 on the CPU:

- the blocking ``inference`` (the legacy ``generate`` path), ``stream``
  (the per-step driver: text deltas, token ids, offsets and usage, stop
  strings that span chunks, ``cancel``), ``batch_inference`` and the
  queued-job driver (interrupt → ``JobMigrated`` → resume) give the JAX
  worker's outputs;
- stream checkpoints cross between the packages and between the two
  serving modes both ways, a complete checkpoint is served from its tail;
- ``engine: jax-speculative`` sends short greedy prompts to the tree
  decoder as the JAX worker does;
- the PD re-run of one handoff key supersedes the earlier adoption
  (``tests/test_pd_chaos.py``'s case, on the port)."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    draft_params_from_numpy,
    params_from_numpy,
)
from distributed_gpu_inference_torch.runtime import kv_handoff as tkv  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.base import JobMigrated  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import base as jbase  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import llm as jllm  # noqa: E402

MODEL = "llama3-tiny"
COMMON = dict(model=MODEL, max_batch_size=4, max_seq_len=128, prefill_buckets=[16, 32, 64],
              prefix_summary_top_n=0, checkpoint_interval_tokens=4,
              serving={"mode": "direct"})
CASES = {
    "plain": {"prompt": "abcd", "max_new_tokens": 10},
    "long": {"prompt": "stream me", "max_new_tokens": 40, "ignore_eos": True},
    "chat": {"messages": [{"role": "user", "content": "stream me"}],
             "max_new_tokens": 12, "ignore_eos": True},
    "sampled": {"prompt": "sample me", "max_new_tokens": 16, "ignore_eos": True,
                "temperature": 0.8, "top_k": 20, "seed": 3},
}


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(11),
                                 jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


def _jax_worker(jparams, cfg):
    def f32_engine(name, eng_cfg, **kw):
        eng_cfg.dtype = "float32"
        return jengine.TPUEngine(name, eng_cfg, params=jparams)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllm, "TPUEngine", f32_engine)
        w = jllm.TPULLMEngine(dict(cfg))
        w.load_model()
    return w


def _port_worker(tree, cfg):
    w = TorchLLMEngine(dict(cfg, dtype="float32", device="cpu",
                            params=params_from_numpy(tree, "cpu")))
    w.load_model()
    return w


@pytest.fixture(scope="module")
def pair(weights):
    """(JAX direct worker, port direct worker), each with a list its
    checkpoint sink appends to."""
    jparams, tree = weights
    jw, tw = _jax_worker(jparams, COMMON), _port_worker(tree, COMMON)
    for w in (jw, tw):
        w.sunk = []
        w.checkpoint_sink = w.sunk.append
    yield jw, tw
    jw.unload()
    tw.unload()


@pytest.fixture(scope="module")
def batcher_port(weights):
    _, tree = weights
    # rounds of 4 tokens: a cadence checkpoint lands mid-stream
    tw = _port_worker(tree, dict(COMMON, serving={"mode": "batcher", "multi_step": 4,
                                                  "max_horizon": 4, "adaptive": False}))
    yield tw
    tw.unload()


def _payload(p):
    """A result payload without its timing."""
    return {k: v for k, v in p.items() if k != "ttft_ms"}


def _stream(w, params, cancel=None, stop_after=None):
    """The chunks of one stream; with ``stop_after``, ``cancel`` is set
    once that many chunks arrived."""
    out = []
    for chunk in w.stream(dict(params), cancel=cancel):
        out.append(chunk)
        if stop_after is not None and len(out) == stop_after:
            cancel.set()
    return out


# ---------------------------------------------------------------- load


def test_direct_mode_loads_without_a_batcher(pair):
    jw, tw = pair
    assert tw.serving is None and tw.loaded and tw.engine is not None
    assert tw.serving_stats() is None and jw.serving_stats() is None
    tw.apply_serving_config({"max_wait_ms": 1.0, "multi_step": 2})    # a no-op
    assert tw.serving is None
    h = tw.health()
    assert h["loaded"] and "serving_stats" not in h and "engine_stats" in h
    assert set(h["engine_stats"]) >= {"requests", "prefill_calls", "decode_calls"}


# ---------------------------------------------------------------- blocking


@pytest.mark.parametrize("case", sorted(CASES))
def test_inference_equals_the_jax_direct_worker(pair, case):
    jw, tw = pair
    want = jw.inference(dict(CASES[case]))
    got = tw.inference(dict(CASES[case]))
    assert _payload(got) == _payload(want)
    assert got["usage"]["completion_tokens"] > 0


def test_inference_cut_by_a_stop_string_equals_jax(pair):
    jw, tw = pair
    text = jw.inference(dict(CASES["long"]))["text"]
    stops = [text[7:9], text[3:5]]          # the first listed one found wins
    want = jw.inference(dict(CASES["long"], stop=stops))
    got = tw.inference(dict(CASES["long"], stop=stops))
    assert _payload(got) == _payload(want)
    assert got["finish_reason"] == "stop"


def test_batch_inference_equals_the_jax_direct_worker(pair):
    jw, tw = pair
    text = jw.inference(dict(CASES["long"]))["text"]
    batch = [dict(CASES["plain"]), dict(CASES["long"], stop=[text[4:6]]),
             dict(CASES["sampled"])]
    want = jw.batch_inference([dict(b) for b in batch])
    got = tw.batch_inference([dict(b) for b in batch])
    assert [_payload(p) for p in got] == [_payload(p) for p in want]
    assert tw.engine.num_active == 0


# ---------------------------------------------------------------- streams


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_equals_the_jax_direct_stream(pair, case):
    jw, tw = pair
    params = dict(CASES[case], stream_id=f"s-{case}")
    want, got = _stream(jw, params), _stream(tw, params)
    assert got == want
    # each event's offset counts the tokens delivered through it
    assert [c["offset"] for c in got] == \
        list(np.cumsum([len(c.get("token_ids", [])) for c in got]))
    assert tw.engine.num_active == 0


def test_stream_with_a_stop_string_across_chunks_equals_jax(pair):
    jw, tw = pair
    text = jw.inference(dict(CASES["long"]))["text"]
    params = dict(CASES["long"], stop=[text[5:9]], stream_id="s-stop")
    want, got = _stream(jw, params), _stream(tw, params)
    assert got == want
    assert got[-1]["finish_reason"] == "stop"
    assert "".join(c.get("text_delta", "") for c in got) == text[:text.find(text[5:9])]


def test_cancel_stops_the_stream_at_a_step_boundary(pair):
    jw, tw = pair
    params = dict(CASES["long"], stream_id="s-cancel")
    want = _stream(jw, params, threading.Event(), stop_after=5)
    got = _stream(tw, params, threading.Event(), stop_after=5)
    assert got == want
    assert got[-1]["done"] and got[-1]["finish_reason"] == "abort"
    assert got[-1]["usage"]["completion_tokens"] < CASES["long"]["max_new_tokens"]
    assert tw.engine.num_active == 0


# ---------------------------------------------------------------- checkpoints


def _ctx(key, ckpt=None, offset=0, text_offset=0):
    return {"key": key, "epoch": 1, "checkpoint": ckpt, "offset": offset,
            "text_offset": text_offset}


def _mid_checkpoint(w, key, params, at=20):
    """A stream on ``w`` cut once a cadence checkpoint holding tokens was
    pushed and ``at`` tokens were delivered → (its chunks so far, that
    checkpoint's state). Cadence pushes go through a background pusher."""
    w.sunk.clear()

    def states():
        return [e["state"] for e in list(w.sunk)
                if e["key"] == key and e["state"]["generated"]]

    eng = w.engine
    real = eng.decode_multi

    def paced(*a, **kw):
        # the batcher's rounds run ahead of the consumer: paced, the slot
        # is still live when a cadence checkpoint is taken
        time.sleep(0.05)
        return real(*a, **kw)

    eng.decode_multi = paced
    try:
        gen = w.stream(dict(params, _failover_ctx=_ctx(key)))
        chunks = _cut(gen, at, states)
    finally:
        del eng.decode_multi
    return chunks, states()[-1]


def _cut(gen, at, states):
    chunks = []
    for chunk in gen:
        chunks.append(chunk)
        if chunk.get("offset", 0) >= at:
            deadline = time.time() + 10.0
            while not states() and time.time() < deadline:
                time.sleep(0.01)
            break
    gen.close()
    return chunks


def _resumed(w, key, params, state, offset, text_offset=0):
    return _stream(w, dict(params, _failover_ctx=_ctx(key, state, offset, text_offset)))


@pytest.mark.parametrize("donor,taker", [("port", "jax"), ("jax", "port"),
                                         ("port", "port batcher"), ("port batcher", "port")])
def test_stream_checkpoints_cross_packages_and_modes(pair, batcher_port, donor, taker):
    jw, tw = pair
    workers = {"jax": jw, "port": tw, "port batcher": batcher_port}
    for w in workers.values():
        if not hasattr(w, "sunk"):
            w.sunk = []
            w.checkpoint_sink = w.sunk.append
    params = dict(CASES["long"])
    key = f"x-{donor}-{taker}".replace(" ", "-")
    full = _stream(jw, dict(params, stream_id=key))
    cut, state = _mid_checkpoint(workers[donor], key, params)
    n = len(state["generated"])
    assert 0 < n < params["max_new_tokens"]
    # the client consumed up to the checkpoint's offset: the taker
    # regenerates the rest and splices on, and the JAX direct worker's own
    # resume of the same state is the reference
    offset = min(n, cut[-1]["offset"])
    text_off = len("".join(c.get("text_delta", "") for c in cut
                           if c["offset"] <= offset))
    want = _resumed(jw, key, params, state, offset, text_off)
    got = _resumed(workers[taker], key, params, state, offset, text_off)
    assert got == want
    whole = [t for c in cut if c["offset"] <= offset for t in c["token_ids"]] + \
        [t for c in got[:-1] for t in c["token_ids"]]
    assert whole == [t for c in full[:-1] for t in c["token_ids"]]
    assert got[0]["offset"] == offset + 1
    assert got[-1]["usage"] == full[-1]["usage"] | {"cached_tokens": got[-1]["usage"]["cached_tokens"]}


@pytest.mark.parametrize("offset", [0, 20, 40])
def test_a_complete_checkpoint_is_served_from_its_tail(pair, offset):
    jw, tw = pair
    params = dict(CASES["long"], stop=["zz-never"])
    req = tds.InferenceRequest(prompt_token_ids=list(tw.tokenizer.encode("stream me")),
                               sampling=tds.SamplingParams(max_new_tokens=40))
    gen = [int(t) for t in np.random.default_rng(5).integers(40, 120, 40)]
    from distributed_gpu_inference_torch.runtime.engine import PreemptedSequence

    state = PreemptedSequence(request=req, prompt_len=len(req.prompt_token_ids),
                              generated=gen, slot_key=(0, 7), start_time=1.0,
                              first_token_time=2.0, cached_tokens=0).to_wire()
    before = tw.engine.stats["requests"]
    want = _resumed(jw, "tail", params, state, offset)
    got = _resumed(tw, "tail", params, state, offset)
    assert got == want
    assert got[-1]["finish_reason"] == "length"
    assert tw.engine.stats["requests"] == before      # the engine was not touched


# ---------------------------------------------------------------- queued jobs


def _interrupt_after(w, rounds):
    """Set ``w``'s drain interrupt once its engine ran ``rounds`` decode
    rounds → a restore callable."""
    eng = w.engine
    real = eng.decode_multi
    seen = [0]

    def decode_multi(*a, **kw):
        out = real(*a, **kw)
        seen[0] += 1
        if seen[0] >= rounds:
            w._interrupt.set()
        return out

    eng.decode_multi = decode_multi

    def restore():
        del eng.decode_multi
        w._interrupt.clear()
    return restore


@pytest.mark.parametrize("taker", ["port", "jax", "port batcher"])
def test_job_interrupt_migrates_and_resumes_to_the_undisturbed_result(
        pair, batcher_port, taker):
    jw, tw = pair
    params = dict(CASES["long"], max_new_tokens=48)
    whole = jw.inference(dict(params, _failover_ctx=_ctx("job-calm")))
    restore = _interrupt_after(tw, 2)
    try:
        with pytest.raises(JobMigrated) as mig:
            tw.inference(dict(params, _failover_ctx=_ctx("job-1")))
    finally:
        restore()
    n = mig.value.tokens
    assert 0 < n < params["max_new_tokens"] and tw.engine.num_active == 0
    assert not tw._live
    w = {"port": tw, "jax": jw, "port batcher": batcher_port}[taker]
    got = w.inference(dict(params, _failover_ctx=_ctx("job-1", mig.value.checkpoint)))
    assert _payload(got)["text"] == whole["text"]
    assert got["usage"]["completion_tokens"] == whole["usage"]["completion_tokens"]


def test_the_jax_direct_job_interrupt_resumes_on_the_port(pair):
    jw, tw = pair
    params = dict(CASES["long"], max_new_tokens=48)
    whole = tw.inference(dict(params, _failover_ctx=_ctx("job-calm-2")))
    jw.interrupt_live()
    try:
        with pytest.raises(jbase.JobMigrated) as mig:
            jw.inference(dict(params, _failover_ctx=_ctx("job-2")))
    finally:
        jw._interrupt.clear()
    got = tw.inference(dict(params, _failover_ctx=_ctx("job-2", mig.value.checkpoint)))
    assert _payload(got) == _payload(whole)


def test_a_complete_job_checkpoint_is_delivered_without_the_engine(pair):
    jw, tw = pair
    params = dict(CASES["plain"], max_new_tokens=6, ignore_eos=True)
    restore = _interrupt_after(tw, 1)
    try:
        with pytest.raises(JobMigrated) as mig:
            tw.inference(dict(params, max_new_tokens=40, _failover_ctx=_ctx("job-3")))
    finally:
        restore()
    state = dict(mig.value.checkpoint)
    state["request"] = dict(state["request"])
    state["request"]["sampling"] = dict(state["request"]["sampling"],
                                        max_new_tokens=len(state["generated"]))
    from distributed_gpu_inference_torch.runtime.engine import PreemptedSequence

    state["crc"] = PreemptedSequence._wire_crc(state)
    before = dict(tw.engine.stats)
    got = tw.inference(dict(params, _failover_ctx=_ctx("job-3", state)))
    want = jw.inference(dict(params, _failover_ctx=_ctx("job-3", state)))
    assert _payload(got) == _payload(want)
    assert got["finish_reason"] == "length" and tw.engine.stats == before


# ---------------------------------------------------------------- tree decoder


def test_the_tree_decoder_serves_short_greedy_prompts_as_jax(weights):
    jparams, tree = weights
    cfg = dict(COMMON, engine="jax-speculative", spec_widths="2,2")
    jw, tw = _jax_worker(jparams, cfg), _port_worker(tree, cfg)
    try:
        tw._spec.draft_params = draft_params_from_numpy(
            jax.tree.map(np.asarray, jw._spec.draft_params), "cpu")
        calls = []
        real = tw._spec.generate
        tw._spec.generate = lambda reqs: calls.append(len(reqs)) or real(reqs)
        for params in (CASES["plain"], CASES["long"], CASES["sampled"]):
            assert _payload(tw.inference(dict(params))) == _payload(jw.inference(dict(params)))
        # a fresh greedy job takes the tree decoder too; a sampled one the engine
        job = dict(CASES["long"], _failover_ctx=_ctx("tree-job"))
        assert _payload(tw.inference(dict(job))) == _payload(jw.inference(dict(job)))
        assert calls == [1, 1, 1]
        assert tw._spec.stats == jw._spec.stats
    finally:
        jw.unload()
        tw.unload()


# ---------------------------------------------------------------- PD


def test_a_pd_rerun_of_one_key_supersedes_the_earlier_adoption(weights):
    """The port's run of ``tests/test_pd_chaos.py``'s re-run case: a prefill
    child re-run after its completion report was lost pushes the SAME key
    again; the second adoption frees the first slot instead of orphaning
    it, and the decode stage then serves the second."""
    _, tree = weights
    cfg = dict(COMMON, max_batch_size=2, max_seq_len=64)
    donor, rx = _port_worker(tree, cfg), _port_worker(tree, cfg)
    try:
        key = "pd-rerun-key"

        slot1 = _adopt(donor, rx, key, max_new_tokens=4)
        assert rx._pd_slots[key][0] == slot1
        slot2 = _adopt(donor, rx, key, max_new_tokens=4)
        assert rx._pd_slots[key][0] == slot2
        assert rx.engine.num_active == 1
        assert rx.pd_stats["adopted_expired"] >= 1
        out = rx.inference({"pd_stage": "decode", "kv_cache_key": key})
        assert out["completion_tokens"] == 4 and rx.engine.num_active == 0
        assert key not in rx._pd_slots
    finally:
        donor.unload()
        rx.unload()


def _adopt(donor, rx, key, max_new_tokens=8):
    """Prefill a fixed prompt on ``donor`` and push its handoff to ``rx``'s
    ``kv_receiver`` under ``key`` → the adopted slot."""
    req = tds.InferenceRequest(
        prompt_token_ids=list(range(10, 26)),
        sampling=tds.SamplingParams(max_new_tokens=max_new_tokens, temperature=0.0,
                                    ignore_eos=True),
        session_id=key)
    slot = donor.engine.submit_batch([req])[0]
    raw = tkv.serialize_handoff(tkv.export_slot_kv(donor.engine, slot))
    donor.engine.finish_slot(slot, cache=False)
    return rx.kv_receiver(raw)["slot"]


def _pd_out(out):
    return {k: v for k, v in out.items() if k not in ("ttft_ms", "e2e_ms")}


@pytest.mark.parametrize("between", ["inference", "batch_inference", "stream"])
def test_an_adopted_slot_outlives_a_direct_request_before_its_decode(weights, between):
    """A handoff adopted on a direct engine waits for its decode stage while
    other requests run there: they share its decode rounds but leave the
    slot bound, and the decode stage then serves what an undisturbed one
    serves. The request run between gives its solo result."""
    _, tree = weights
    donor, rx = _port_worker(tree, COMMON), _port_worker(tree, COMMON)
    params = dict(CASES["long"], stream_id="s-between")
    run = {"inference": lambda: rx.inference(dict(params)),
           "batch_inference": lambda: rx.batch_inference([dict(params)]),
           "stream": lambda: _stream(rx, params)}[between]
    try:
        _adopt(donor, rx, "pd-calm")
        calm = rx.inference({"pd_stage": "decode", "kv_cache_key": "pd-calm"})
        solo = run()
        slot = _adopt(donor, rx, "pd-busy")
        seq = rx.engine.slots[slot]
        got = run()
        assert rx.engine.slots[slot] is seq and seq.finish_reason is not None
        out = rx.inference({"pd_stage": "decode", "kv_cache_key": "pd-busy"})
        assert _pd_out(out) == _pd_out(calm) | {"kv_cache_key": "pd-busy"}
        assert out["completion_tokens"] == 8 and rx.engine.num_active == 0
        def timeless(x):
            return [_payload(c) for c in x] if isinstance(x, list) else _payload(x)
        assert timeless(got) == timeless(solo)
    finally:
        donor.unload()
        rx.unload()


def test_a_direct_stream_outlives_a_blocking_request_between_its_steps(pair):
    """The direct stream holds the engine lock one step at a time: a
    blocking request served between two of its steps shares the rounds but
    leaves the stream's slot to it, and the stream delivers what it does
    alone."""
    _, tw = pair
    params = dict(CASES["long"], stream_id="s-interleaved")
    solo = _stream(tw, params)
    blocking = tw.inference(dict(CASES["plain"]))
    gen = tw.stream(dict(params))
    got = [next(gen), next(gen)]
    assert _payload(tw.inference(dict(CASES["plain"]))) == _payload(blocking)
    got += list(gen)
    # the rounds the blocking request ran reach the stream as one chunk
    for key in ("token_ids", "text_delta"):
        assert [x for c in got[:-1] for x in c[key]] == [x for c in solo[:-1] for x in c[key]]
    assert got[-1] == solo[-1] and tw.engine.num_active == 0


# ---------------------------------------------------------------- claims


def test_a_direct_engine_takes_exclusive_claims(pair):
    """The worker runs a direct-mode engine's queued jobs under exclusive
    claims (no live batcher), and ``DirectServer`` falls back to
    ``try_begin_job`` for its streams: a second stream while one runs is
    refused with 503."""
    import http.client
    import json
    from types import SimpleNamespace

    from distributed_gpu_inference_torch.utils.data_structures import WorkerState
    from distributed_gpu_inference_torch.worker import main as tmain
    from distributed_gpu_inference_torch.worker.direct_server import DirectServer

    _, tw = pair
    stub = SimpleNamespace(engines={"llm": tw})
    stub._llm_serving_active = lambda: tmain.Worker._llm_serving_active(stub)
    assert tmain.Worker._llm_serving_active(stub) is False
    assert tmain.Worker._job_runs_shared(stub, {"type": "llm"}) is False

    class Claims:
        def __init__(self):
            self.state, self.engines, self.log = WorkerState.IDLE, {"llm": tw}, []

        def try_begin_serving(self):
            self.log.append("shared")
            return True

        def end_serving(self):
            pass

        def try_begin_job(self):
            self.log.append("exclusive")
            if self.state != WorkerState.IDLE:
                return False
            self.state = WorkerState.BUSY
            return True

        def end_job(self):
            self.state = WorkerState.IDLE

        def get_status(self):
            return {"state": self.state.value}

    worker = Claims()
    server = DirectServer(worker, host="127.0.0.1", port=0)
    server.start()
    real = tw.engine.decode_step

    def slow_step():
        time.sleep(0.05)
        return real()

    tw.engine.decode_step = slow_step
    try:
        def post(path, body):
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            conn.request("POST", path, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            return conn, conn.getresponse()

        body = {"type": "llm", "params": dict(CASES["long"], max_new_tokens=20)}
        conn1, r1 = post("/inference/stream", body)
        assert r1.status == 200
        r1.readline()                     # the stream is running
        conn2, r2 = post("/inference/stream", body)
        assert r2.status == 503 and b"busy" in r2.read()
        conn2.close()
        text = r1.read()
        conn1.close()
        assert b'"done": true' in text
    finally:
        del tw.engine.decode_step
        server.stop()
    assert worker.log[:2] == ["exclusive", "exclusive"] and "shared" not in worker.log
