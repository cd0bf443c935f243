"""The port's control-plane client on ``http.client`` (``worker/
api_client.py``): the retry ladder of the JAX client's five retry cases
(full-jitter backoff, the retry budget, 599 for a dead transport, 4xx never
retried, success after transient 5xx), sticky plane failover with the
``/health`` probe, bearer tokens and HMAC signatures the JAX plane's
``RequestSigner`` verifies, socket timeouts and concurrent callers — each
against a scripted ``http.server`` on loopback."""

import json
import random
import socket
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List

import pytest

from distributed_gpu_inference_torch.worker import api_client as mod
from distributed_gpu_inference_torch.worker.api_client import APIClient, APIError
from distributed_gpu_inference_tpu.server.security import RequestSigner as PlaneSigner


class Scripted:
    """A loopback HTTP server answering every request with
    ``handler(method, path, headers, body) -> (status, json body)``;
    ``"drop"`` closes the connection without an answer. Records requests."""

    def __init__(self, handler):
        self.handler, self.requests = handler, []
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _do(self):
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                outer.requests.append((self.command, self.path, dict(self.headers), body))
                out = outer.handler(self.command, self.path, self.headers, body)
                if out == "drop":
                    self.close_connection = True
                    self.connection.shutdown(socket.SHUT_RDWR)
                    return
                status, payload = out
                data = b"" if payload is None else json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = _do

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    def paths(self):
        return [p for _, p, _, _ in self.requests]


@pytest.fixture
def serve():
    servers = []

    def make(handler):
        servers.append(Scripted(handler))
        return servers[-1]

    yield make
    for s in servers:
        s.close()


def _dead_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()                   # nothing listens there now
    return f"http://127.0.0.1:{port}"


def _client(url, monkeypatch, sleeps: List[float], **kw) -> APIClient:
    # recorded sleeps: the module's clock is replaced, not the process's
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(sleep=sleeps.append,
                                                           time=time.time))
    return APIClient(url, timeout_s=5.0, **kw)


class MaxRng:
    def uniform(self, a, b):
        return b


def test_backoff_is_full_jitter_bounded_by_cap(serve, monkeypatch):
    srv = serve(lambda *a: (503, {"detail": "restarting"}))
    schedules = []
    for seed in (1, 2):
        sleeps: List[float] = []
        c = _client(srv.url, monkeypatch, sleeps, max_retries=3, backoff_s=0.5,
                    rng=random.Random(seed))
        with pytest.raises(APIError):
            c._request("GET", "/x")
        assert len(sleeps) == 3
        for attempt, s in enumerate(sleeps):
            assert 0.0 <= s <= 0.5 * 2**attempt
        schedules.append(sleeps)
    assert schedules[0] != schedules[1]


def test_retry_budget_caps_total_sleep(serve, monkeypatch):
    srv = serve(lambda *a: (503, {"detail": "down"}))
    sleeps: List[float] = []
    c = _client(srv.url, monkeypatch, sleeps, max_retries=6, backoff_s=1.0,
                retry_budget_s=4.0, rng=MaxRng())
    with pytest.raises(APIError) as ei:
        c._request("GET", "/x")
    assert ei.value.status == 503
    # caps would be 1,2,4,8,16,32; budget 4 allows 1 + 2 + (clamped) 1
    assert sleeps == [1.0, 2.0, 1.0]
    assert len(srv.requests) == 4          # initial + 3 budgeted retries, not 7


@pytest.mark.parametrize("failure", ["refused", "dropped", "timeout"])
def test_transport_errors_respect_budget_and_raise_599(serve, monkeypatch, failure):
    if failure == "refused":
        url = _dead_url()
    else:
        srv = serve(lambda *a: "drop" if failure == "dropped"
                    else (time.sleep(1.0), (200, {}))[1])
        url = srv.url
    sleeps: List[float] = []
    c = _client(url, monkeypatch, sleeps, max_retries=10, backoff_s=1.0,
                retry_budget_s=2.0, rng=MaxRng())
    c._timeout_s = 0.2          # every socket carries the configured timeout
    with pytest.raises(APIError) as ei:
        c._request("GET", "/x")
    assert ei.value.status == 599
    assert sum(sleeps) == pytest.approx(2.0)


def test_4xx_never_retried_never_sleeps(serve, monkeypatch):
    srv = serve(lambda *a: (403, {"detail": "nope"}))
    sleeps: List[float] = []
    c = _client(srv.url, monkeypatch, sleeps, max_retries=5)
    with pytest.raises(APIError) as ei:
        c._request("GET", "/x")
    assert (ei.value.status, ei.value.detail) == (403, "nope")
    assert len(srv.requests) == 1 and sleeps == []


def test_success_after_transient_5xx(serve, monkeypatch):
    state = {"n": 0}

    def handler(*a):
        state["n"] += 1
        return (500, {"detail": "boom"}) if state["n"] < 3 else (200, {"ok": True})

    srv = serve(handler)
    sleeps: List[float] = []
    c = _client(srv.url, monkeypatch, sleeps, max_retries=3, rng=random.Random(0))
    assert c._request("GET", "/x").json()["ok"] is True
    assert state["n"] == 3 and len(sleeps) == 2


@pytest.mark.parametrize("first", ["5xx", "refused"])
def test_plane_failover_is_sticky_and_health_probed(serve, monkeypatch, first):
    if first == "5xx":
        bad = serve(lambda *a: (503, {"detail": "plane down"})).url
    else:
        bad = _dead_url()
    good = serve(lambda m, p, *a: (200, {"status": "ok"} if p == "/health"
                                   else {"worker_id": "w", "auth_token": "t",
                                         "refresh_token": "r", "signing_secret": "s",
                                         "ok": True}))
    sleeps: List[float] = []
    c = _client([bad, good.url], monkeypatch, sleeps, max_retries=0)
    assert c.heartbeat() == good.handler("POST", "/x", {}, b"")[1]
    # rotated without a backoff step, after a /health probe of the peer
    assert sleeps == [] and c.plane_failovers == 1 and c.base_url == good.url
    assert good.paths()[:2] == ["/health", "/api/v1/workers/None/heartbeat"]
    c.register({"name": "x"})                 # sticky: straight to the survivor
    assert good.paths()[-1] == "/api/v1/workers/register"
    assert c.plane_failovers == 1


def test_requests_carry_bearer_token_and_a_signature_the_plane_verifies(serve, monkeypatch):
    srv = serve(lambda *a: (200, {"ok": True}))
    c = _client(srv.url + "/prefix", monkeypatch, [], worker_id="w-1", auth_token="tok",
                signing_secret="sek")
    c.complete_job("j1", success=True, result={"text": "hi"}, assignment_epoch=3)
    c.fetch_remote_config()
    signer = PlaneSigner()
    for method, path, headers, body in srv.requests:
        assert path.startswith("/prefix/api/v1/workers/w-1/")
        assert headers["Authorization"] == "Bearer tok"
        # the exact path and body bytes sent are what was signed
        assert signer.verify("sek", method, path, body, headers["X-Timestamp"],
                             headers["X-Signature"])
        assert not signer.verify("sek", method, path, body + b" ",
                                 headers["X-Timestamp"], headers["X-Signature"])
    assert json.loads(srv.requests[0][3]) == {
        "success": True, "result": {"text": "hi"}, "error": None, "assignment_epoch": 3}


def test_no_job_is_204_and_next_job_is_never_retried(serve, monkeypatch):
    srv = serve(lambda *a: (204, None))
    c = _client(srv.url, monkeypatch, [], worker_id="w-1", auth_token="tok")
    assert c.fetch_next_job() is None
    srv.handler = lambda *a: (503, {"detail": "busy"})
    with pytest.raises(APIError):
        c.fetch_next_job()
    assert len(srv.requests) == 2              # retries=0: one request each


def test_concurrent_callers_each_get_their_own_answer(serve, monkeypatch):
    # the heartbeat thread, the poll loop and the job pool share one client
    srv = serve(lambda m, p, h, b: (time.sleep(0.01), (200, json.loads(b)))[1])
    c = _client(srv.url, monkeypatch, [], worker_id="w-1", auth_token="tok",
                signing_secret="sek")
    out = {}

    def call(i):
        out[i] = c.heartbeat(status=f"s{i}", config_version=i)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert {i: (r["status"], r["config_version"]) for i, r in out.items()} == {
        i: (f"s{i}", i) for i in range(16)}
