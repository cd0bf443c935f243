"""Clients across packages: the JAX SDK's ``InferenceClient`` and the JAX
worker's ``APIClient`` against the port's control plane, and the port's SDK
(``distributed_gpu_inference_torch/sdk/client.py``, on ``http.client``)
against the JAX plane and the port's own.

Every case runs the same calls: queued jobs (create → wait), the
``/jobs/sync`` long-poll, get / cancel / ``queue_stats`` / a timeline, the
429 + ``Retry-After`` contract, ``stream_chat`` through a direct worker
that drops the stream mid-generation (the client resumes on a failover
worker from the last offset, no gap and no duplicate), a direct call whose
worker answers busy (queued fallback), and the hedged race (the backup
leg wins over a slow primary, whose leg is cancelled).

The direct workers are scripted ``http.server`` stand-ins registered on the
plane with their URLs; a poller thread on the other package's worker
``APIClient`` serves the queue.
"""

import http.server
import importlib
import json
import threading
import time
from typing import Any, Dict, List

import pytest

pytest.importorskip("torch")

JAX, PORT = "distributed_gpu_inference_tpu", "distributed_gpu_inference_torch"
CASES = [(JAX, PORT), (PORT, JAX), (PORT, PORT)]
IDS = ["jax-sdk-on-port-plane", "port-sdk-on-jax-plane", "port-sdk-on-port-plane"]


def mod(root: str, rel: str) -> Any:
    return importlib.import_module(f"{root}.{rel}")


class DirectStandIn:
    """A scripted direct worker: ``/inference`` (optionally slow or busy),
    ``/inference/cancel`` (records hedge keys) and ``/inference/stream``
    (SSE with token offsets; the first fresh stream dies after
    ``cut_after`` events without a done event; a resume continues from its
    offset)."""

    TOKENS = list(range(101, 109))

    def __init__(self, name: str, delay_s: float = 0.0, busy: bool = False,
                 cut_after: int = 0) -> None:
        self.name = name
        self.delay_s = delay_s
        self.busy = busy
        self.cut_after = cut_after
        self.cancels: List[str] = []
        self.requests: List[Dict[str, Any]] = []
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *a: Any) -> None:
                pass

            def _json(self, status: int, payload: Any) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if status == 503:
                    self.send_header("Retry-After", "0")
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:  # noqa: N802
                n = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(n) or b"{}")
                outer.requests.append({"path": self.path, **req})
                if self.path == "/inference/cancel":
                    outer.cancels.append(req.get("hedge_key"))
                    return self._json(200, {"cancelled": True})
                if outer.busy:
                    return self._json(503, {"detail": "busy"})
                if self.path == "/inference":
                    time.sleep(outer.delay_s)
                    return self._json(200, {"result": {"text": f"direct:{outer.name}"}})
                if self.path == "/inference/stream":
                    return self._stream(req)
                return self._json(404, {"detail": "no route"})

            def _stream(self, req: Dict[str, Any]) -> None:
                resume = req.get("resume")
                start = int(resume["offset"]) if resume else 0
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                for i in range(start, len(outer.TOKENS)):
                    if not resume and outer.cut_after and i >= outer.cut_after:
                        return              # the worker dies mid-stream
                    ev = {"text_delta": f"t{i}", "token_ids": [outer.TOKENS[i]],
                          "offset": i + 1}
                    self.wfile.write(f"data: {json.dumps(ev)}\n\n".encode())
                    self.wfile.flush()
                done = {"done": True, "finish_reason": "length", "offset": len(outer.TOKENS),
                        "usage": {"completion_tokens": len(outer.TOKENS)}}
                self.wfile.write(f"data: {json.dumps(done)}\n\n".encode())

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class QueueWorker:
    """A worker ``APIClient`` of the given package polling the plane and
    completing every job it claims with ``queued:<prompt>``."""

    def __init__(self, root: str, url: str) -> None:
        self.api = mod(root, "worker.api_client").APIClient(url, backoff_s=0.0)
        self.api.register({"name": "qw", "region": "us-west",
                           "machine_fingerprint": f"qw-{root}",
                           "supported_types": ["llm"]})
        self.api.heartbeat(status="idle")
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self) -> None:
        while not self._stop.wait(0.02):
            try:
                job = self.api.fetch_next_job()
                if job is None:
                    continue
                prompt = job["params"].get("prompt")
                self.api.complete_job(job["id"], True, result={
                    "text": f"queued:{prompt}", "usage": {"completion_tokens": 1},
                    "finish_reason": "stop"},
                    assignment_epoch=job.get("assignment_epoch"))
            except Exception:  # noqa: BLE001 — next tick retries
                pass

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=10)


def register_direct(root: str, url: str, stand_in: DirectStandIn, name: str) -> str:
    api = mod(root, "worker.api_client").APIClient(url, backoff_s=0.0)
    api.register({"name": name, "region": "us-west", "machine_fingerprint": f"d-{name}",
                  "supported_types": ["llm"], "supports_direct": True,
                  "direct_url": stand_in.url})
    api.heartbeat(status="idle")
    return api.worker_id


def plane_cls(root: str) -> Any:
    return mod(root, "testing.harness").LiveControlPlane


@pytest.mark.parametrize("sdk_root,plane_root", CASES, ids=IDS)
def test_queued_sync_and_job_lifecycle(sdk_root, plane_root):
    sdk = mod(sdk_root, "sdk.client")
    with plane_cls(plane_root)() as cp:
        # the worker client of the other package than the plane's
        qw = QueueWorker(JAX if plane_root == PORT else PORT, cp.url)
        c = sdk.InferenceClient(cp.url, backoff_s=0.01)
        try:
            jid = c.create_job("llm", {"prompt": "alpha", "trace_id": "tr-alpha"})
            job = c.wait_for_job(jid, timeout_s=20, poll_s=0.02)
            assert job["status"] == "completed" and job["result"]["text"] == "queued:alpha"
            assert c.get_job(jid)["id"] == jid
            out = c.chat(prompt="beta", sync=True, timeout_s=20)
            assert out["text"] == "queued:beta"
            out = c.chat(prompt="gamma", sync=False, timeout_s=20)
            assert out["text"] == "queued:gamma"
            tl = c.get_request_timeline(jid)
            assert any(e["event"] == "server.submitted" for e in tl["events"]), tl
            stats = c.queue_stats()
            assert stats["jobs"]["completed"] >= 3
            qw.close()
            jid2 = c.create_job("llm", {"prompt": "never"})
            c.cancel_job(jid2)
            assert c.get_job(jid2)["status"] == "cancelled"
            with pytest.raises(sdk.InferenceClientError) as ei:
                c.get_job("does-not-exist")
            assert ei.value.status == 404
        finally:
            qw.close()
            c.close()


@pytest.mark.parametrize("sdk_root,plane_root", CASES, ids=IDS)
def test_backpressure_answers_429_with_retry_after(sdk_root, plane_root):
    sdk = mod(sdk_root, "sdk.client")
    with plane_cls(plane_root)(submit_queue_limit=1) as cp:
        register_direct(PORT, cp.url, DirectStandIn("x"), "bp")
        c = sdk.InferenceClient(cp.url, backoff_s=0.0, max_retries=0)
        try:
            c.create_job("llm", {"prompt": "one"})
            with pytest.raises(sdk.InferenceClientError) as ei:
                c.create_job("llm", {"prompt": "two"})
            assert ei.value.status == 429
            assert ei.value.retry_after_s is not None and ei.value.retry_after_s >= 1.0
        finally:
            c.close()
    # no worker at all: every server answers 503, a NoWorkersAvailable
    with plane_cls(plane_root)() as cp:
        c = sdk.InferenceClient(cp.url, backoff_s=0.0, max_retries=0)
        try:
            with pytest.raises(sdk.NoWorkersAvailable):
                c.chat(prompt="nobody", sync=True, timeout_s=2)
        finally:
            c.close()


@pytest.mark.parametrize("sdk_root,plane_root", CASES, ids=IDS)
def test_stream_chat_resumes_on_a_failover_worker(sdk_root, plane_root):
    sdk = mod(sdk_root, "sdk.client")
    a = DirectStandIn("a", cut_after=3)
    b = DirectStandIn("b", cut_after=3)
    with plane_cls(plane_root)() as cp:
        ids = {register_direct(PORT, cp.url, a, "a"): a,
               register_direct(JAX, cp.url, b, "b"): b}
        c = sdk.InferenceClient(cp.url, backoff_s=0.0)
        try:
            chunks = list(c.stream_chat(prompt="stream me", max_new_tokens=8,
                                        max_stream_resumes=2, timeout_s=20))
        finally:
            c.close()
    for s in (a, b):
        s.close()
    assert chunks[-1]["done"] is True
    toks = [t for ch in chunks[:-1] for t in ch.get("token_ids") or []]
    assert toks == DirectStandIn.TOKENS              # no gap, no duplicate
    offs = [ch["offset"] for ch in chunks]
    assert offs == sorted(offs)
    streams = [r for s in (a, b) for r in s.requests if r["path"] == "/inference/stream"]
    assert len(streams) == 2
    first, resume = sorted(streams, key=lambda r: "resume" in r)
    assert resume["resume"] == {"stream_id": first["stream_id"], "offset": 3,
                                "text_offset": len("t0t1t2")}
    # the resume went to the OTHER worker: the one that died is excluded
    assert sum(bool(s.requests) for s in ids.values()) == 2


@pytest.mark.parametrize("sdk_root,plane_root", CASES, ids=IDS)
def test_direct_calls_fall_back_to_the_queue(sdk_root, plane_root):
    sdk = mod(sdk_root, "sdk.client")
    busy = DirectStandIn("busy", busy=True)
    with plane_cls(plane_root)() as cp:
        register_direct(PORT, cp.url, busy, "busy")
        qw = QueueWorker(PORT, cp.url)
        c = sdk.InferenceClient(cp.url, backoff_s=0.0)
        try:
            out = c.chat(prompt="fallback", use_direct=True, timeout_s=20)
            assert out["text"] == "queued:fallback"
            assert [r["path"] for r in busy.requests] == ["/inference"]
            # a healthy direct worker answers itself
            busy.busy = False
            c._direct_cache = None
            out = c.chat(prompt="direct", use_direct=True, timeout_s=20)
            assert out["text"] == "direct:busy"
        finally:
            qw.close()
            c.close()
            busy.close()


@pytest.mark.parametrize("sdk_root,plane_root", CASES, ids=IDS)
def test_the_hedged_race_takes_the_faster_leg(sdk_root, plane_root):
    sdk = mod(sdk_root, "sdk.client")
    legs = [DirectStandIn("a"), DirectStandIn("b")]
    with plane_cls(plane_root)() as cp:
        ids = {register_direct(PORT, cp.url, s, s.name): s for s in legs}
        admin = sdk.InferenceClient(cp.url)
        admin._request("PUT", "/api/v1/admin/health", {"enabled": True, "hedge": True})
        admin.close()
        c = sdk.InferenceClient(cp.url, backoff_s=0.0)
        try:
            worker = c._get_nearest_worker(hedge=True)
            assert worker["hedge"]["delay_ms"] >= 0.0
            # the discovered primary is made the slow leg
            primary, other = ids[worker["worker_id"]], ids[worker["hedge"]["worker_id"]]
            primary.delay_s = 1.5
            t0 = time.monotonic()
            out = c.chat(prompt="race", use_direct=True, deadline_s=30.0, timeout_s=20)
            took = time.monotonic() - t0
        finally:
            c.close()
    time.sleep(1.6)
    for s in legs:
        s.close()
    assert out["text"] == f"direct:{other.name}"
    assert took < 1.4
    sent = [r for r in primary.requests if r["path"] == "/inference"]
    assert sent and primary.cancels == [sent[0]["params"]["hedge_key"]]


def test_port_retry_rules_through_a_stand_in_transport():
    """The port SDK's retry ladder on a scripted transport (``transport=``,
    the stand-in for the network): 503 moves to the next server without a
    retry, 429 honours Retry-After and surfaces its hint once retries run
    out, an effectful POST is never re-sent after a 5xx, and a refused
    connection (the request never left) fails a POST over to the next
    server."""
    sdk = mod(PORT, "sdk.client")
    calls: List[tuple] = []
    script: Dict[str, List[Any]] = {}

    def send(method, url, body, headers, timeout):
        calls.append((method, url))
        step = script[url.split("/api")[0]].pop(0)
        if isinstance(step, Exception):
            raise step
        status, hdrs, payload = step
        return status, hdrs, json.dumps(payload).encode()

    def client(**kw):
        return sdk.InferenceClient(["http://a", "http://b"], backoff_s=0.0,
                                   transport=send, **kw)

    script.update({"http://a": [(503, {}, {"detail": "no workers"})],
                   "http://b": [(200, {}, {"id": "j", "status": "queued"})]})
    assert client().get_job("j")["id"] == "j"
    assert [u for _, u in calls] == ["http://a/api/v1/jobs/j", "http://b/api/v1/jobs/j"]

    calls.clear()
    script.update({"http://a": [(429, {"Retry-After": "0"}, {"detail": "busy"})] * 2,
                   "http://b": [(429, {}, {"retry_after_s": 0.0})] * 2})
    with pytest.raises(sdk.InferenceClientError) as ei:
        client(max_retries=1).create_job("llm", {"prompt": "x"})
    assert ei.value.status == 429 and ei.value.retry_after_s is not None
    assert len(calls) == 4

    calls.clear()
    script.update({"http://a": [(500, {}, {"detail": "boom"})], "http://b": []})
    with pytest.raises(sdk.InferenceClientError) as ei:
        client(max_retries=3).create_job("llm", {"prompt": "x"})
    assert ei.value.status == 500 and len(calls) == 1

    calls.clear()
    script.update({"http://a": [sdk.ConnectError("refused")],
                   "http://b": [(200, {}, {"job_id": "j2"})]})
    assert client().create_job("llm", {"prompt": "x"}) == "j2"
    assert [u for _, u in calls] == ["http://a/api/v1/jobs", "http://b/api/v1/jobs"]
