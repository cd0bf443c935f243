"""The port's direct server (``http.server``) over real sockets: the routes,
admission pipeline, status codes and SSE framing of the JAX package's
aiohttp server (``tests/test_worker_direct_server.py``,
``tests/test_streaming.py``), hedged cancel, and the JAX SDK's
``stream_chat`` reading a stream from it. Every socket call has a timeout
and every server is stopped in a ``finally``."""

import http.client
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.utils.data_structures import WorkerState  # noqa: E402
from distributed_gpu_inference_torch.worker.direct_server import (  # noqa: E402
    DirectServer,
    sse_event,
)
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

TIMEOUT = 30.0


class FakeWorker:
    """The worker claim surface with an echo engine (the JAX package's
    ``FakeWorker``)."""

    def __init__(self):
        self.state = WorkerState.IDLE
        self.engines = {"llm": self}

    def try_begin_job(self):
        if self.state != WorkerState.IDLE:
            return False
        self.state = WorkerState.BUSY
        return True

    def end_job(self):
        if self.state == WorkerState.BUSY:
            self.state = WorkerState.IDLE

    def inference(self, params):
        if params.get("boom"):
            raise RuntimeError("kaboom")
        return {"text": "ok", "params": params}

    def get_status(self):
        return {"state": self.state.value, "task_types": ["llm"]}


class ServingWorker(FakeWorker):
    """A worker over a real engine with shared serving claims (up to
    ``cap`` concurrent requests) and a checkpoint store for stream
    resume."""

    def __init__(self, engine, cap=8):
        super().__init__()
        self.engines = {"llm": engine}
        self.cap, self.active, self.max_active = cap, 0, 0
        self.lock = threading.Lock()
        self.checkpoints = {}
        engine.checkpoint_sink = self.sink

    def sink(self, entry):
        self.checkpoints[entry["key"]] = entry

    def try_begin_serving(self):
        with self.lock:
            if self.state not in (WorkerState.IDLE, WorkerState.BUSY) \
                    or self.active >= self.cap:
                return False
            self.active += 1
            self.max_active = max(self.max_active, self.active)
            return True

    def end_serving(self):
        with self.lock:
            self.active -= 1

    def adopt_stream_checkpoint(self, stream_id):
        entry = self.checkpoints.get(stream_id)
        return None if entry is None else {"checkpoint": entry["state"],
                                           "epoch": entry["epoch"]}


class Server:
    """``DirectServer`` on an ephemeral port, stopped on exit."""

    def __init__(self, worker):
        self.ds = DirectServer(worker, host="127.0.0.1", port=0)

    def __enter__(self):
        self.ds.start()
        return self

    def __exit__(self, *exc):
        self.ds.stop()

    def call(self, method, path, body=None, raw=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.ds.port, timeout=TIMEOUT)
        try:
            data = raw if raw is not None else (
                None if body is None else json.dumps(body).encode())
            conn.request(method, path, body=data,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read() or b"null")
        finally:
            conn.close()

    def open_stream(self, body):
        conn = http.client.HTTPConnection("127.0.0.1", self.ds.port, timeout=TIMEOUT)
        conn.request("POST", "/inference/stream", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        return conn, conn.getresponse()


def read_events(resp, limit=None):
    """Parse SSE events off a response: [(id or None, data dict)]."""
    events, ev_id = [], None
    while limit is None or len(events) < limit:
        line = resp.readline()
        if not line:
            break
        line = line.decode().rstrip("\n")
        if line.startswith("id: "):
            ev_id = int(line[4:])
        elif line.startswith("data: "):
            events.append((ev_id, json.loads(line[6:])))
            ev_id = None
    return events


def hold_engine(monkeypatch, eng, n, pace=0.0):
    """Make ``eng.decode_multi`` (the batcher's engine thread) sleep ``pace``
    s a round and, once a live slot holds ``n`` tokens (all of them already
    handed to its stream), wait before the next round until the returned
    event is set: the test acts on a generation that is surely mid-flight,
    however loaded the machine."""
    release = threading.Event()
    real = eng.decode_multi

    def held(*a, **kw):
        if any(s is not None and s.finish_reason is None and len(s.generated) >= n
               for s in eng.slots):
            release.wait(TIMEOUT)
        time.sleep(pace)
        return real(*a, **kw)

    monkeypatch.setattr(eng, "decode_multi", held)
    return release


def wait_for(cond, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


# ---------------------------------------------------------------- fake engine


def test_health_and_status():
    with Server(FakeWorker()) as s:
        status, body = s.call("GET", "/health")
        assert status == 200 and body["status"] == "ok"
        status, body = s.call("GET", "/status")
        assert status == 200 and body["state"] == "idle"


def test_inference_roundtrip():
    with Server(FakeWorker()) as s:
        status, body = s.call("POST", "/inference", {"type": "llm",
                                                      "params": {"prompt": "hi"}})
        assert status == 200 and body["result"]["text"] == "ok"
        assert s.ds.stats["requests"] == 1
        stats = s.ds.wire_stats()
        assert len(stats["recent_ms"]) == 1 and stats["new_errors"] == 0
        assert s.ds.wire_stats()["recent_ms"] == []      # drained


def test_503_when_busy_or_draining():
    w = FakeWorker()
    with Server(w) as s:
        for state in (WorkerState.BUSY, WorkerState.DRAINING, WorkerState.OFFLINE):
            w.state = state
            status, body = s.call("POST", "/inference", {"type": "llm"})
            assert status == 503 and state.value in body["detail"]
        assert s.ds.stats["rejected"] == 3


@pytest.mark.parametrize("raw", [b"[1, 2, 3]", b"{not json", b"", b'"text"'])
def test_bad_body_400(raw):
    with Server(FakeWorker()) as s:
        for path in ("/inference", "/inference/stream"):
            status, body = s.call("POST", path, raw=raw)
            assert status == 400 and body["detail"]


def test_bad_content_length_400():
    with Server(FakeWorker()) as s:
        conn = http.client.HTTPConnection("127.0.0.1", s.ds.port, timeout=TIMEOUT)
        try:
            conn.putrequest("POST", "/inference")
            conn.putheader("Content-Length", "twelve")
            conn.endheaders()
            r = conn.getresponse()
            assert r.status == 400 and json.loads(r.read())["detail"] == "invalid JSON"
        finally:
            conn.close()


def test_load_control_applies_to_direct_traffic():
    w = FakeWorker()
    w.accept = False
    w.should_accept_job = lambda job: w.accept
    w.noted = []
    w.note_job_done = w.noted.append
    with Server(w) as s:
        assert s.call("POST", "/inference", {"type": "llm"})[0] == 503
        assert s.ds.stats["rejected"] == 1
        w.accept = True
        assert s.call("POST", "/inference", {"type": "llm"})[0] == 200
        assert len(w.noted) == 1       # bookkeeping recorded for direct jobs
        assert w.state == WorkerState.IDLE


def test_unknown_task_type_404():
    with Server(FakeWorker()) as s:
        assert s.call("POST", "/inference", {"type": "tts"})[0] == 404
        assert s.call("POST", "/inference/stream", {"type": "tts"})[0] == 404
        assert s.call("GET", "/nowhere")[0] == 404


def test_engine_error_500():
    with Server(FakeWorker()) as s:
        status, body = s.call("POST", "/inference", {"type": "llm",
                                                      "params": {"boom": 1}})
        assert status == 500 and "kaboom" in body["detail"]
        assert s.ds.wire_stats()["new_errors"] == 1


def test_engine_that_does_not_stream_501():
    with Server(FakeWorker()) as s:
        assert s.call("POST", "/inference/stream", {"type": "llm"})[0] == 501


def test_reserved_params_are_stripped():
    with Server(FakeWorker()) as s:
        status, body = s.call("POST", "/inference", {"type": "llm", "params": {
            "prompt": "hi", "_failover_ctx": {"checkpoint": {}}, "_cancel_evt": 1,
            "_flight_picked_up_ts": 5.0, "_flight_tl": "x"}})
        assert status == 200
        assert body["result"]["params"] == {"prompt": "hi"}


def test_threaded_lifecycle():
    """start() binds before it returns (port 0 → an ephemeral port on
    ``.port``); stop() shuts down and joins."""
    ds = DirectServer(FakeWorker(), host="127.0.0.1", port=0)
    ds.start()
    try:
        assert ds.port != 0
        conn = http.client.HTTPConnection("127.0.0.1", ds.port, timeout=TIMEOUT)
        conn.request("GET", "/health")
        assert conn.getresponse().status == 200
        conn.close()
    finally:
        ds.stop()
    assert ds._thread is None
    with pytest.raises(OSError):
        conn = http.client.HTTPConnection("127.0.0.1", ds.port, timeout=5.0)
        conn.request("GET", "/health")
        conn.getresponse()


def test_hedged_cancel_flips_the_server_minted_event():
    w = FakeWorker()
    started, seen = threading.Event(), {}

    def inference(params):
        evt = params["_cancel_evt"]
        seen["evt"] = evt
        started.set()
        return {"text": "aborted" if evt.wait(TIMEOUT) else "ran to the end"}

    w.inference = inference
    with Server(w) as s:
        out = {}
        t = threading.Thread(target=lambda: out.update(r=s.call(
            "POST", "/inference", {"type": "llm", "params": {"hedge_key": "h1"}})))
        t.start()
        try:
            assert started.wait(TIMEOUT)
            assert s.call("POST", "/inference/cancel", {"hedge_key": "h1"}) == \
                (200, {"cancelled": True})
            # idempotent; unknown keys are a no-op 200
            assert s.call("POST", "/inference/cancel", {"hedge_key": "h1"}) == \
                (200, {"cancelled": False})
            assert s.call("POST", "/inference/cancel", {"hedge_key": "zz"}) == \
                (200, {"cancelled": False})
        finally:
            t.join(TIMEOUT)
        assert not t.is_alive()
        assert out["r"] == (200, {"result": {"text": "aborted"}})
        assert s.ds.stats["hedge_cancels"] == 1
        assert s.ds.wire_stats()["hedge_cancels"] == 1
        assert s.ds._cancels == {}
        assert s.call("POST", "/inference/cancel", raw=b"{bad")[0] == 400


def test_sse_event_framing_byte_for_byte():
    chunk = {"text_delta": "hé", "token_ids": [5], "offset": 3}
    assert sse_event(chunk) == (
        b'id: 3\ndata: {"text_delta": "h\\u00e9", "token_ids": [5], "offset": 3}\n\n')
    assert sse_event({"done": True}) == b'data: {"done": true}\n\n'


# ---------------------------------------------------------------- real engine


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(get_model_config("llama3-tiny"), jax.random.PRNGKey(7),
                              jnp.float32)


@pytest.fixture(scope="module")
def llm(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    # rounds of at most 4 tokens: a client that hangs up mid-stream does so
    # while the engine still decodes (the paced tests sleep each round)
    e = TorchLLMEngine(dict(model="llama3-tiny", max_batch_size=4, max_seq_len=128,
                            prefill_buckets=[16, 32, 64], dtype="float32",
                            device="cpu", params=params_from_numpy(tree, "cpu"),
                            serving={"max_horizon": 4}))
    e.load_model()
    yield e
    e.unload()


def test_direct_server_sse(llm):
    w = ServingWorker(llm)
    with Server(w) as s:
        conn, resp = s.open_stream({"type": "llm", "params": {"prompt": "hi",
                                                              "max_new_tokens": 6}})
        try:
            assert resp.status == 200
            assert resp.getheader("Content-Type") == "text/event-stream"
            assert resp.getheader("Transfer-Encoding") == "chunked"
            events = read_events(resp)
        finally:
            conn.close()
        # every event carries its offset in the SSE id field
        assert all(ev_id == data["offset"] for ev_id, data in events)
        body, final = [d for _, d in events[:-1]], events[-1][1]
        assert final["done"] is True and final["usage"]["completion_tokens"] >= 1
        assert [d["offset"] for d in body] == list(range(1, len(body) + 1))
        want = llm.inference({"prompt": "hi", "max_new_tokens": 6})
        assert "".join(d["text_delta"] for d in body) == want["text"]
        # the shared claim was used and released after the stream
        assert w.max_active == 1 and w.active == 0
        assert wait_for(lambda: llm.engine.num_active == 0)


def test_direct_server_stream_busy_503(llm):
    w = ServingWorker(llm)
    w.state = WorkerState.DRAINING
    with Server(w) as s:
        assert s.call("POST", "/inference/stream", {"type": "llm", "params": {}})[0] == 503
        assert s.call("POST", "/inference", {"type": "llm", "params": {}})[0] == 503


def test_concurrent_requests_share_the_batch(llm):
    w = ServingWorker(llm, cap=3)
    prompts = ["abcd", "stream me", "a"]
    with Server(w) as s:
        out = [None] * len(prompts)

        def call(i):
            out[i] = s.call("POST", "/inference", {"type": "llm", "params": {
                "prompt": prompts[i], "max_new_tokens": 16, "ignore_eos": True}})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert all(status == 200 for status, _ in out)
    for (status, body), p in zip(out, prompts):
        assert body["result"]["text"] == llm.inference(
            {"prompt": p, "max_new_tokens": 16, "ignore_eos": True})["text"]
    assert w.active == 0 and w.max_active >= 1


def test_shared_claim_cap_refuses_the_next_request(llm):
    w = ServingWorker(llm, cap=0)
    with Server(w) as s:
        assert s.call("POST", "/inference", {"type": "llm", "params": {}})[0] == 503
        assert s.ds.stats["rejected"] == 1


def test_hedged_cancel_aborts_a_real_generation(llm, monkeypatch):
    release = hold_engine(monkeypatch, llm.engine, n=1)
    w = ServingWorker(llm)
    with Server(w) as s:
        out = {}
        t = threading.Thread(target=lambda: out.update(r=s.call(
            "POST", "/inference", {"type": "llm", "params": {
                "prompt": "abcd", "max_new_tokens": 100, "ignore_eos": True,
                "hedge_key": "race-1"}})))
        t.start()
        try:
            assert wait_for(lambda: any(
                sl is not None and sl.generated for sl in llm.engine.slots))
            assert s.call("POST", "/inference/cancel", {"hedge_key": "race-1"})[1] == \
                {"cancelled": True}
        finally:
            release.set()
            t.join(TIMEOUT)
        assert not t.is_alive()
        status, body = out["r"]
        assert status == 200 and body["result"]["finish_reason"] == "abort"
        assert body["result"]["usage"]["completion_tokens"] < 100
        assert wait_for(lambda: llm.engine.num_active == 0)


def test_client_disconnect_cancels_the_stream(llm, monkeypatch):
    # the engine waits for the hang-up, then paces its rounds so the server
    # still has events to write (its writes are how it notices the hang-up)
    release = hold_engine(monkeypatch, llm.engine, n=4, pace=0.02)
    w = ServingWorker(llm)
    before = llm.serving.get_stats()["cancelled"]
    with Server(w) as s:
        conn, resp = s.open_stream({"type": "llm", "params": {
            "prompt": "abcd", "max_new_tokens": 100, "ignore_eos": True}})
        try:
            assert len(read_events(resp, limit=3)) == 3
        finally:
            resp.close()
            conn.close()
            release.set()
        assert wait_for(lambda: llm.serving.get_stats()["cancelled"] == before + 1
                        and llm.engine.num_active == 0 and w.active == 0)


def test_resume_without_a_checkpoint_409_and_failed_adoption_503(llm):
    w = ServingWorker(llm)
    with Server(w) as s:
        body = {"type": "llm", "params": {"prompt": "x"},
                "resume": {"stream_id": "nope", "offset": 3}}
        assert s.call("POST", "/inference/stream", body)[0] == 409

        def down(stream_id):
            raise ConnectionError("control plane unreachable")

        w.adopt_stream_checkpoint = down
        assert s.call("POST", "/inference/stream", body)[0] == 503
        assert w.active == 0


def test_sdk_stream_chat_reads_the_port_server(llm):
    """The JAX package's SDK, with only its discovery pointed at the port's
    server, streams the same text the port's blocking call returns."""
    from distributed_gpu_inference_tpu.sdk import InferenceClient

    w = ServingWorker(llm)
    with Server(w) as s:
        c = InferenceClient("http://127.0.0.1:9", backoff_s=0.0, timeout_s=TIMEOUT)
        c._get_nearest_worker = lambda **kw: {
            "worker_id": "port", "direct_url": f"http://127.0.0.1:{s.ds.port}"}
        try:
            chunks = list(c.stream_chat(prompt="stream me", max_new_tokens=20,
                                        ignore_eos=True))
        finally:
            c.close()
    want = llm.inference({"prompt": "stream me", "max_new_tokens": 20,
                          "ignore_eos": True})
    assert chunks[-1]["done"] is True
    assert "".join(ch.get("text_delta", "") for ch in chunks[:-1]) == want["text"]
    assert chunks[-1]["usage"]["completion_tokens"] == 20
    assert [ch["offset"] for ch in chunks[:-1]] == list(range(1, 21))


@pytest.mark.parametrize("adopt", ["admission", "latest"])
def test_dropped_stream_resumes_exactly_once(llm, jparams, monkeypatch, adopt):
    """A stream dropped after 5 events and resumed through ``resume
    {stream_id, offset, text_offset}`` — from the zero-token admission
    checkpoint or the latest cadence one — splices with no gap and no
    duplicate: the ids and text equal the uninterrupted JAX run."""
    params = {"prompt": "stream me", "max_new_tokens": 40, "ignore_eos": True}
    geom = dict(max_batch_size=4, max_seq_len=128, prefill_buckets=(16, 32, 64),
                dtype="float32")
    ref = jengine.TPUEngine("llama3-tiny", jengine.EngineConfig(**geom),
                            params=jparams).generate([jds.InferenceRequest(
                                prompt_token_ids=llm.tokenizer.encode("stream me"),
                                sampling=jds.SamplingParams(max_new_tokens=40,
                                                            ignore_eos=True))])[0]
    release = hold_engine(monkeypatch, llm.engine, n=8, pace=0.02)
    w = ServingWorker(llm)
    entries = []
    w.sink = lambda entry: entries.append(entry)
    llm.checkpoint_sink = w.sink
    sid = f"drop-{adopt}"
    with Server(w) as s:
        conn, resp = s.open_stream({"type": "llm", "params": params, "stream_id": sid})
        try:
            first = [d for _, d in read_events(resp, limit=5)]
        finally:
            resp.close()
            conn.close()
            release.set()
        assert _wait_for_quiet(llm, w)
        assert [d["offset"] for d in first] == [1, 2, 3, 4, 5]
        assert entries and entries[0]["state"]["generated"] == []
        pick = entries[0] if adopt == "admission" else entries[-1]
        w.checkpoints = {sid: pick}
        text = "".join(d["text_delta"] for d in first)
        conn, resp = s.open_stream({"type": "llm", "params": params, "resume": {
            "stream_id": sid, "offset": 5, "text_offset": len(text)}})
        try:
            assert resp.status == 200
            rest = [d for _, d in read_events(resp)]
        finally:
            conn.close()
    body, final = rest[:-1], rest[-1]
    assert [d["offset"] for d in body] == list(range(6, 41))
    ids = [t for d in first + body for t in d["token_ids"]]
    assert ids == list(ref.token_ids)
    assert text + "".join(d["text_delta"] for d in body) == \
        llm.tokenizer.decode(ref.token_ids)
    assert final["done"] and final["offset"] == 40 and final["stream_id"] == sid
    assert final["usage"]["completion_tokens"] == 40
    assert _wait_for_quiet(llm, w)


def _wait_for_quiet(llm, w):
    return wait_for(lambda: llm.engine.num_active == 0 and w.active == 0)
