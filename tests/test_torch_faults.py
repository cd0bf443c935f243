"""The port's fault seams (``testing/faults.py``) and breakers
(``runtime/io_guard.py``) against the JAX package's: one rule list fires
identically in both packages (same seed, same trace), each seam has the
JAX seam's effect, the breaker state machine matches on a virtual clock —
and the seams sit where the JAX worker has them: the API client's
``worker.api.request``, the direct server's ``worker.direct.request`` and
``worker.direct.stream``, and the atomic writer's ``io.file.write``."""

import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from distributed_gpu_inference_torch.runtime import io_guard as tguard
from distributed_gpu_inference_torch.testing import faults as tfaults
from distributed_gpu_inference_torch.utils.data_structures import WorkerState
from distributed_gpu_inference_torch.worker.api_client import APIClient, APIError
from distributed_gpu_inference_torch.worker.direct_server import DirectServer
from distributed_gpu_inference_tpu.runtime import io_guard as jguard
from distributed_gpu_inference_tpu.testing import faults as jfaults

RULE_FIELDS = ("site", "kind", "prob", "after", "times", "where", "status",
               "delay_s", "cut", "match")


def _both(rules):
    """The same rule list for each package."""
    return rules, [tfaults.FaultRule(**{k: getattr(r, k) for k in RULE_FIELDS})
                   for r in rules]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome is what we compare
        return (type(exc).__name__, str(exc))


CALLS = [
    ("kv_pressure", ("kv.block.alloc",), {"num_free": 3}),
    ("io_fault", ("io.spill.host.put",), {"key": "k1"}),
    ("io_fault", ("io.spill.host.get",), {"key": "k1"}),
    ("io_bytes", ("io.spill.remote.get", b"0123456789abcdef"), {"key": "k2"}),
    ("io_bytes", ("io.spill.remote.put", b"0123456789abcdef"), {"key": "k3"}),
    ("io_bytes", ("io.spill.remote.get", None), {"key": "k4"}),
    ("stream_cut", ("worker.direct.stream",), {"stream_id": "s", "worker": "w1"}),
    ("http_reject", ("worker.direct.request",), {"worker": "w1"}),
    ("http_reject", ("worker.direct.request",), {"worker": "w2"}),
    ("io_fault", ("io.file.write",), {"path": "/x"}),
] * 6

PLANS = {
    "errors": [jfaults.FaultRule("io.spill.*", "error", prob=0.5),
               jfaults.FaultRule("worker.direct.request", "error", status=503,
                                 match={"worker": "w1"})],
    "bytes": [jfaults.FaultRule("io.spill.remote.get", "corrupt", after=1),
              jfaults.FaultRule("io.spill.remote.put", "truncate", cut=5, times=2)],
    "flaps": [jfaults.flap("worker.direct.*", times=3, after=2),
              jfaults.FaultRule("kv.block.alloc", "pressure", prob=0.3),
              jfaults.FaultRule("io.file.write", "drop", times=1)],
    "delays": [jfaults.FaultRule("*", "delay", delay_s=0.0, prob=0.7)],
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_one_rule_list_fires_identically_in_both_packages(plan):
    jr, tr = _both(PLANS[plan])
    results = []
    for faults, rules in ((jfaults, jr), (tfaults, tr)):
        with faults.active(faults.FaultPlan(seed=42, rules=rules)) as fp:
            out = [_outcome(lambda: getattr(faults, fn)(*a, **kw)) for fn, a, kw in CALLS]
        results.append((out, fp.trace, [(r.hits, r.fired) for r in fp.rules]))
    assert results[1] == results[0]
    assert results[0][1]                      # something fired


def test_seams_are_passthrough_without_a_plan():
    assert tfaults.current() is None
    assert tfaults.io_bytes("io.spill.remote.get", b"abc") == b"abc"
    assert tfaults.kv_pressure("kv.block.alloc", num_free=0) is False
    assert tfaults.http_reject("worker.direct.request") is None
    assert tfaults.wrap_http("worker.api.request", lambda: 7) == 7
    plan = tfaults.install(tfaults.FaultPlan())
    try:
        with pytest.raises(RuntimeError, match="already installed"):
            tfaults.install(tfaults.FaultPlan())
    finally:
        tfaults.uninstall()
    assert tfaults.current() is None and plan.trace == []
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.FaultRule("x", "explode")


# ---------------------------------------------------------------- breakers


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_breaker_state_machine_matches_the_jax_breaker():
    script = ["f", "f", "allow", "f", "allow", "tick", "allow", "allow", "f",
              "allow", "tick", "allow", "s", "allow", "f", "f", "f", "tick",
              "allow", "s", "f"]
    runs = []
    for mod in (jguard, tguard):
        clock = Clock()
        br = mod.IOBreaker("host", threshold=3, open_s=10.0, jitter=0.0, clock=clock)
        out = []
        for step in script:
            if step == "f":
                br.record_failure()
            elif step == "s":
                br.record_success()
            elif step == "tick":
                clock.t += 10.0
            else:
                out.append(br.allow())
            out.append((br.state, br.state_code, br.trips, br.closed))
        runs.append(out)
    assert runs[1] == runs[0]
    assert runs[0][-1][2] == 3               # three trips along the way


def test_breaker_env_config_matches(monkeypatch):
    for env in ({}, {"DGI_IO_BREAKER_THRESHOLD": "5", "DGI_IO_BREAKER_OPEN_S": "2.5",
                     "DGI_IO_BREAKER_JITTER": "0"},
                {"DGI_IO_BREAKER_THRESHOLD": "bogus", "DGI_IO_BREAKER_DISABLE": "1"}):
        for k in ("DGI_IO_BREAKER_THRESHOLD", "DGI_IO_BREAKER_OPEN_S",
                  "DGI_IO_BREAKER_JITTER", "DGI_IO_BREAKER_DISABLE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tguard.breaker_env_config() == jguard.breaker_env_config()


def test_atomic_write_seam_leaves_the_old_file(tmp_path):
    path = tmp_path / "creds.json"
    tguard.atomic_write_text(path, "old")
    rule = tfaults.FaultRule("io.file.write", "error", times=1)
    with tfaults.active(tfaults.FaultPlan(rules=[rule])):
        with pytest.raises(OSError, match="fault injected"):
            tguard.atomic_write_text(path, "new")
        tguard.atomic_write_text(path, "newer")      # the rule fired once
    assert path.read_text() == "newer"
    assert [p.name for p in tmp_path.iterdir()] == ["creds.json"]


# ---------------------------------------------------------------- the API client seam


class Plane:
    """A loopback server answering every POST with ``{"n": count}``."""

    def __init__(self):
        self.count = 0
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length") or 0))
                outer.count += 1
                data = json.dumps({"n": outer.count}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def plane():
    p = Plane()
    yield p
    p.close()


def _client(url, **kw):
    c = APIClient(url, max_retries=3, backoff_s=0.001, retry_budget_s=5.0, timeout_s=5.0,
                  **kw)
    c.fault_tag = "w1"
    return c


def test_api_seam_errors_and_drops_ride_the_retry_ladder(plane):
    api = _client(plane.url)
    rules = [tfaults.FaultRule("worker.api.request", "error", status=503, times=2,
                               match={"path": "/api/v1/a", "worker": "w1"}),
             tfaults.FaultRule("worker.api.request", "drop", where="response", times=1,
                               match={"path": "/api/v1/b"}),
             tfaults.FaultRule("worker.api.request", "duplicate", times=1,
                               match={"path": "/api/v1/c"}),
             tfaults.FaultRule("worker.api.request", "error", status=404,
                               match={"path": "/api/v1/d"})]
    with tfaults.active(tfaults.FaultPlan(seed=1, rules=rules)) as fp:
        # two synthesized 503s, then the real answer: the plane saw one call
        assert api._request("POST", "/api/v1/a", {}).json() == {"n": 1}
        # delivered, the response lost: retried, the plane saw it twice
        assert api._request("POST", "/api/v1/b", {}).json() == {"n": 3}
        # duplicate delivery: the second answer is returned
        assert api._request("POST", "/api/v1/c", {}).json() == {"n": 5}
        with pytest.raises(APIError) as err:          # 4xx: never retried
            api._request("POST", "/api/v1/d", {})
        assert err.value.status == 404
    assert plane.count == 5
    assert [kind for _, kind, _ in fp.trace] == ["error", "error", "drop", "duplicate",
                                                 "error"]


def test_api_seam_flap_exhausts_to_599(plane):
    api = _client(plane.url)
    with tfaults.active(tfaults.FaultPlan(rules=[tfaults.flap("worker.api.request",
                                                              times=10)])):
        with pytest.raises(APIError) as err:
            api._request("GET", "/health")
    assert err.value.status == 599 and plane.count == 0


# ---------------------------------------------------------------- the direct server seams


class StreamEngine:
    """An engine whose ``inference`` echoes and whose stream yields five
    token events and a final chunk."""

    async def stream_inference(self, params):
        for i in range(5):
            yield {"text_delta": str(i), "token_ids": [i], "offset": i + 1}
        yield {"done": True, "finish_reason": "length", "offset": 5}

    def inference(self, params):
        return {"text": "ok"}


class Worker:
    def __init__(self):
        self.state = WorkerState.IDLE
        self.engines = {"llm": StreamEngine()}
        self.fault_tag = "w1"

    def try_begin_job(self):
        if self.state != WorkerState.IDLE:
            return False
        self.state = WorkerState.BUSY
        return True

    def end_job(self):
        self.state = WorkerState.IDLE

    def get_status(self):
        return {"state": self.state.value}


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _wait_idle(w, timeout_s=10.0):
    deadline = time.time() + timeout_s
    while w.state != WorkerState.IDLE and time.time() < deadline:
        time.sleep(0.01)


def test_direct_seams_reject_cut_and_kill_streams():
    w = Worker()
    ds = DirectServer(w, host="127.0.0.1", port=0)
    ds.start()
    try:
        rules = [tfaults.FaultRule("worker.direct.request", "error", status=502, times=1,
                                   match={"worker": "w1"}),
                 tfaults.FaultRule("worker.direct.request", "drop", times=1),
                 tfaults.FaultRule("worker.direct.stream", "drop", after=2, times=1)]
        with tfaults.active(tfaults.FaultPlan(rules=rules)):
            status, body = _post(ds.port, "/inference", {"params": {}})
            assert status == 502 and b"flaky" in body
            with pytest.raises((http.client.RemoteDisconnected, ConnectionError)):
                _post(ds.port, "/inference", {"params": {}})
            status, body = _post(ds.port, "/inference", {"params": {}})
            assert status == 200 and json.loads(body)["result"] == {"text": "ok"}
            # the stream dies after two events: no final chunk
            conn = http.client.HTTPConnection("127.0.0.1", ds.port, timeout=10)
            conn.request("POST", "/inference/stream",
                         body=json.dumps({"params": {}}).encode())
            resp = conn.getresponse()
            assert resp.status == 200
            with pytest.raises(http.client.IncompleteRead) as cut:
                resp.read()
            conn.close()
            data = [json.loads(line[6:]) for line in
                    cut.value.partial.decode().splitlines() if line.startswith("data: ")]
            assert [d["offset"] for d in data] == [1, 2]
            assert not any(d.get("done") for d in data)
        # the cut stream's handler releases its claim only after it closed the
        # generator, which may land after the client saw the cut: the next
        # stream waits for it, or it meets a busy worker (503)
        _wait_idle(w)
        # no plan: the whole stream and its final chunk
        conn = http.client.HTTPConnection("127.0.0.1", ds.port, timeout=10)
        conn.request("POST", "/inference/stream", body=json.dumps({"params": {}}).encode())
        text = conn.getresponse().read().decode()
        conn.close()
        assert text.count("data: ") == 6 and '"done": true' in text
        assert ds.stats["rejected"] == 1
        # every claim released (the handler releases after its last write)
        _wait_idle(w)
        assert w.state == WorkerState.IDLE
    finally:
        ds.stop()


def test_seam_raises_a_transport_error():
    # the drop surfaces as what a dead socket raises: the client's
    # transport errors (OSError) catch it
    rule = tfaults.FaultRule("worker.api.request", "drop")
    with tfaults.active(tfaults.FaultPlan(rules=[rule])):
        with pytest.raises(OSError):
            tfaults.wrap_http("worker.api.request", lambda: None)
    assert issubclass(tfaults.FaultInjected, ConnectionError)
