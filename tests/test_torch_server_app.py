"""The port's control plane (``distributed_gpu_inference_torch/server/app.py``
on ``server/web.py``) against the JAX plane (aiohttp), over real sockets.

One seeded script of HTTP calls — two workers registering, heartbeats with
batcher capacity and prefix summaries, 20 jobs of mixed types, priorities,
prefixes and tenants, polls, checkpoints (one with ``migrate``),
completions, a release and a cancel, then ``queue_stats``, a timeline,
admin reads, ``/health``, ``/regions`` and the ``/metrics`` names — runs
against a JAX ``LiveControlPlane`` and a port one under the same frozen
clock. Status codes, normalised JSON bodies, the ``Retry-After`` header and
the worker each job is given to must be equal; the sqlite schemas must be
equal, and a DB written by one plane must serve from the other.

The transport's own contract (route order, 404/405, long-polls that hold
up nothing, the degraded-store middleware on every route, the CLI's
``--port 0``) is tested on the port's plane alone.
"""

import asyncio
import http.client
import json
import os
import re
import socket
import sqlite3
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.runtime.prefix_summary import PrefixHotSet  # noqa: E402
from distributed_gpu_inference_torch.server.security import RequestSigner  # noqa: E402
from distributed_gpu_inference_torch.testing.harness import (  # noqa: E402
    LiveControlPlane as PortPlane,
)
from distributed_gpu_inference_tpu.testing.harness import (  # noqa: E402
    LiveControlPlane as JaxPlane,
)

T0 = 1_760_000_000.0
API = "/api/v1"
# uuids, and the 16-hex trace ids the plane draws for untraced jobs
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"
                  r"|\b[0-9a-f]{32}\b|\b[0-9a-f]{16}\b")
# credentials, and the config stamp a dataclass default takes from the
# real clock when its module is first imported
SECRET_KEYS = {"auth_token", "refresh_token", "signing_secret", "updated_at"}


def http_call(port: int, method: str, path: str, body: Any = None,
              headers: Optional[Dict[str, str]] = None,
              raw: Optional[bytes] = None, timeout: float = 20.0
              ) -> Tuple[int, Any, Dict[str, str]]:
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    hdrs = dict(headers or {})
    if data is not None:
        hdrs.setdefault("Content-Type", "application/json")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=data, headers=hdrs)
        resp = conn.getresponse()
        content = resp.read()
        ctype = resp.getheader("Content-Type") or ""
        out: Any = content.decode("utf-8", errors="replace")
        if ctype.startswith("application/json"):
            out = json.loads(content)
        keep = {k: resp.getheader(k) for k in ("Retry-After", "Allow")
                if resp.getheader(k) is not None}
        keep["ctype"] = ctype
        return resp.status, out, keep
    finally:
        conn.close()


def normalise(obj: Any, ids: Dict[str, str]) -> Any:
    """uuids → order of first appearance; credentials → a placeholder."""
    if isinstance(obj, dict):
        return {k: ("<secret>" if k in SECRET_KEYS else normalise(v, ids))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [normalise(v, ids) for v in obj]
    if isinstance(obj, str):
        return UUID.sub(lambda m: ids.setdefault(m.group(0), f"<id{len(ids)}>"), obj)
    return obj


class Script:
    """The seeded call script, played against one plane."""

    def __init__(self, port: int, clock: Dict[str, float], seed: int = 0) -> None:
        self.port = port
        self.clock = clock
        self.rng = np.random.default_rng(seed)
        self.log: List[Any] = []
        self.creds: Dict[str, Dict[str, Any]] = {}
        self.signer = RequestSigner()
        self.assigned: List[Tuple[str, str]] = []

    def tick(self, dt: float = 0.25) -> None:
        self.clock["t"] += dt

    def call(self, method: str, path: str, body: Any = None,
             worker: Optional[str] = None, record: bool = True) -> Tuple[int, Any]:
        self.tick()
        headers: Dict[str, str] = {}
        if worker is not None:
            c = self.creds[worker]
            headers["Authorization"] = f"Bearer {c['auth_token']}"
            data = b"" if body is None else json.dumps(body).encode()
            headers.update(self.signer.sign(c["signing_secret"], method, path, data))
        status, out, hdrs = http_call(self.port, method, path, body, headers)
        if record:
            self.log.append((method, re.sub(UUID, "<id>", path), status, out,
                             {k: v for k, v in hdrs.items() if k != "ctype"}))
        return status, out

    def wid(self, name: str) -> str:
        return self.creds[name]["worker_id"]

    def play(self) -> None:
        rng = self.rng
        for name, region in (("w0", "us-west"), ("w1", "eu-west")):
            st, out = self.call("POST", f"{API}/workers/register", {
                "name": name, "region": region, "machine_fingerprint": f"fp-{name}",
                "supported_types": ["llm", "embedding"], "supports_direct": True,
                "direct_url": "http://127.0.0.1:9", "num_chips": 1 + (name == "w1"),
                "topology": {"chip_type": "cpu", "num_chips": 1, "hbm_gb_per_chip": 4.0,
                             "mesh_shape": [1], "mesh_axis_names": ["data"],
                             "ici_bandwidth_gbps": 0.0, "dcn_bandwidth_gbps": 25.0,
                             "peak_bf16_tflops": 0.0}})
            assert st == 200, out
            self.creds[name] = out
        heads = ["You are a careful assistant. " * 6, "Contract text follows. " * 8]
        prompts = [heads[i % 2] + f"question {i} " + "x" * int(rng.integers(0, 120))
                   for i in range(20)]
        for name in ("w0", "w1"):
            hs = PrefixHotSet(top_n=16)
            for p in prompts[(name == "w1")::2][:5]:
                hs.note(p)
            st, _ = self.call("POST", f"{API}/workers/{self.wid(name)}/heartbeat", {
                "status": "idle", "engine_stats": {
                    "batcher": {"capacity": 4, "active_slots": int(rng.integers(0, 3)),
                                "queue_depth": 0, "avg_occupancy": 0.25},
                    "prefix_summary": hs.wire()}}, worker=name)
            assert st == 200
        jobs: List[str] = []
        for i, p in enumerate(prompts):
            body: Dict[str, Any] = {
                "type": "llm" if i % 5 else "embedding",
                "params": ({"prompt": p, "max_new_tokens": int(rng.integers(4, 64))}
                           if i % 5 else {"texts": [p[:40]]}),
                "priority": int(rng.integers(0, 3)),
            }
            if i % 3 == 0:
                body["params"]["trace_id"] = f"trace-{i}"
            if i % 4 == 0:
                body["tenant"] = f"tenant{i % 3}"
                body["tier"] = ["paid", "free", "batch"][i % 3]
            if i % 7 == 0:
                body["preferred_region"] = "eu-west"
            st, out = self.call("POST", f"{API}/jobs", body)
            assert st in (200, 201), out
            jobs.append(out["job_id"])
        # the last queued job is cancelled before anyone claims it
        self.call("DELETE", f"{API}/jobs/{jobs[-1]}")
        step = 0
        for _ in range(40):
            name = "w0" if step % 2 == 0 else "w1"
            step += 1
            st, out = self.call("GET", f"{API}/workers/{self.wid(name)}/next-job",
                                worker=name)
            if st == 204:
                continue
            job = out["job"]
            self.assigned.append((job["id"], name))
            epoch = job.get("assignment_epoch")
            path = f"{API}/workers/{self.wid(name)}/jobs/{job['id']}"
            k = len(self.assigned)
            if k == 2:
                self.call("POST", path + "/checkpoint", {
                    "assignment_epoch": epoch, "migrate": True,
                    "state": {"token_ids": [1, 2, 3], "text": "abc"}}, worker=name)
                continue
            if k == 3:
                self.call("POST", path + "/release", {}, worker=name)
                continue
            if k == 4:
                self.call("POST", path + "/checkpoint", {
                    "assignment_epoch": epoch,
                    "state": {"token_ids": [4, 5], "text": "de"}}, worker=name)
                # a heartbeat that carries this claim and another one
                self.call("POST", f"{API}/workers/{self.wid(name)}/heartbeat", {
                    "status": "busy", "current_job_id": job["id"],
                    "active_job_ids": [job["id"], jobs[0]]}, worker=name)
            if k == 5:
                # a zombie completion: the wrong epoch is fenced
                self.call("POST", path + "/complete", {
                    "success": True, "result": {"text": "z"},
                    "assignment_epoch": int(epoch or 0) + 5}, worker=name)
            self.call("POST", path + "/complete", {
                "success": k != 6, "error": None if k != 6 else "boom",
                "result": {"text": f"done {k}", "usage": {"completion_tokens": k,
                                                          "prompt_tokens": 3},
                           "timeline": {"trace_id": job["params"].get("trace_id"),
                                        "source": f"worker:{name}",
                                        "events": [["worker.poll", self.clock["t"], None]],
                                        "done": True, "dropped": 0}
                           if job["params"].get("trace_id") else None},
                "assignment_epoch": epoch}, worker=name)
            # the duplicate delivery of that completion is idempotent
            if k == 7:
                self.call("POST", path + "/complete", {
                    "success": True, "result": {"text": f"done {k}"},
                    "assignment_epoch": epoch}, worker=name)
        for j in jobs:
            self.call("GET", f"{API}/jobs/{j}")
        self.call("GET", f"{API}/jobs/stats/queue")
        self.call("GET", f"{API}/debug/requests/{jobs[0]}/timeline")
        self.call("GET", f"{API}/debug/requests/trace-3/timeline")
        self.call("GET", f"{API}/debug/requests/slowest")
        self.call("GET", f"{API}/jobs/direct/nearest")
        self.call("GET", f"{API}/jobs/direct/nearest?region=eu-west&hedge=1")
        for path in ("/admin/workers", "/admin/routing", "/admin/admission",
                     "/admin/health", "/admin/stats/realtime", "/workers",
                     f"/workers/{self.wid('w0')}", "/admin/usage/summary",
                     "/admin/privacy/compliance", "/jobs/nonexistent-id"):
            self.call("GET", API + path)
        self.call("PUT", f"{API}/admin/routing", {"affinity_weight": 0.3})
        self.call("PUT", f"{API}/admin/routing", {"affinity_weight": "bad"})
        self.call("POST", f"{API}/workers/{self.wid('w1')}/going-offline", {}, worker="w1")
        self.call("POST", f"{API}/workers/{self.wid('w1')}/offline", {}, worker="w1")
        self.call("GET", f"{API}/workers/{self.wid('w0')}/next-job", worker="w0")
        self.call("POST", f"{API}/workers/{self.wid('w0')}/heartbeat", {"status": "idle"})
        self.call("GET", f"{API}/jobs/stats/queue")
        self.call("GET", "/health")
        self.call("GET", "/regions")


def metric_names(port: int) -> List[str]:
    _, text, _ = http_call(port, "GET", "/metrics")
    return sorted({ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                   if ln and not ln.startswith("#") and "_created" not in ln})


@pytest.fixture
def frozen(monkeypatch):
    clock = {"t": T0}
    monkeypatch.setattr(time, "time", lambda: clock["t"])
    return clock


def play_on(plane_cls: Any, frozen: Dict[str, float], db: str) -> Dict[str, Any]:
    frozen["t"] = T0
    with plane_cls(db_path=db, require_signing=True) as cp:
        s = Script(cp.port, frozen)
        s.play()
        ids: Dict[str, str] = {}
        out = {"log": normalise(s.log, ids),
               "assigned": normalise(s.assigned, ids),
               "metrics": metric_names(cp.port),
               "rows": normalise(cp.query(
                   "SELECT id, status, worker_id, assignment_epoch, retry_count, "
                   "priority, type FROM jobs ORDER BY created_at, id"), ids)}
    return out


def test_the_seeded_script_answers_alike_on_both_planes(frozen, tmp_path):
    jax = play_on(JaxPlane, frozen, str(tmp_path / "jax.sqlite"))
    port = play_on(PortPlane, frozen, str(tmp_path / "port.sqlite"))
    assert len(port["log"]) == len(jax["log"]) > 80
    for a, b in zip(jax["log"], port["log"]):
        assert b == a
    assert port["assigned"] == jax["assigned"]
    assert {w for _, w in port["assigned"]} == {"w0", "w1"}
    statuses = {s for _, _, s, _, _ in port["log"]}
    assert {200, 204, 404, 409}.issubset(statuses), statuses
    assert port["rows"] == jax["rows"]
    assert port["metrics"] == jax["metrics"]
    assert "inference_requests_total" in port["metrics"]


def schema(db: str) -> List[Tuple[str, str]]:
    con = sqlite3.connect(db)
    try:
        return sorted(con.execute(
            "SELECT name, sql FROM sqlite_master WHERE sql IS NOT NULL").fetchall()) + [
            ("user_version", str(con.execute("PRAGMA user_version").fetchone()[0]))]
    finally:
        con.close()


@pytest.mark.parametrize("writer,reader", [(JaxPlane, PortPlane), (PortPlane, JaxPlane)],
                         ids=["jax-writes-port-reads", "port-writes-jax-reads"])
def test_a_db_written_by_one_plane_serves_from_the_other(frozen, tmp_path, writer, reader):
    db = str(tmp_path / "shared.sqlite")
    frozen["t"] = T0
    with writer(db_path=db, require_signing=True) as cp:
        s = Script(cp.port, frozen)
        s.play()
        jobs = [r["id"] for r in cp.query("SELECT id FROM jobs ORDER BY created_at, id")]
        before = [http_call(cp.port, "GET", f"{API}/jobs/{j}")[:2] for j in jobs]
        stats = http_call(cp.port, "GET", f"{API}/jobs/stats/queue")[:2]
        workers = http_call(cp.port, "GET", f"{API}/admin/workers")[:2]
    with reader(db_path=db, require_signing=True) as cp:
        after = [http_call(cp.port, "GET", f"{API}/jobs/{j}")[:2] for j in jobs]
        assert after == before
        assert http_call(cp.port, "GET", f"{API}/jobs/stats/queue")[:2] == stats
        assert http_call(cp.port, "GET", f"{API}/admin/workers")[:2] == workers
        # the worker's credentials (hashes at rest) authenticate on the reader
        s.port = cp.port
        st, _ = s.call("POST", f"{API}/workers/{s.wid('w0')}/heartbeat", {"status": "idle"},
                       worker="w0")
        assert st == 200


def test_the_sqlite_schemas_are_identical(tmp_path):
    dbs = []
    for cls in (JaxPlane, PortPlane):
        db = str(tmp_path / f"{cls.__module__.split('.')[0]}.sqlite")
        with cls(db_path=db):
            pass
        dbs.append(schema(db))
    assert dbs[1] == dbs[0]
    assert len(dbs[0]) > 5


# ---------------------------------------------------------------------------
# the transport (port plane alone)
# ---------------------------------------------------------------------------


@pytest.fixture
def port_plane():
    with PortPlane() as cp:
        yield cp


def test_static_routes_win_over_path_parameters(port_plane):
    p = port_plane.port
    st, out, _ = http_call(p, "GET", f"{API}/debug/requests/slowest")
    assert st == 200 and isinstance(out, dict)
    st, out, _ = http_call(p, "GET", f"{API}/jobs/stats/queue")
    assert st == 200 and "queued" in out
    st, out, _ = http_call(p, "GET", f"{API}/admin/privacy/compliance")
    assert st == 200 and isinstance(out, dict)
    st, out, _ = http_call(p, "GET", f"{API}/jobs/direct/nearest")
    assert (st, out) == (404, {"detail": "no direct workers available"})


def test_unknown_paths_and_methods_answer_as_aiohttp_does(port_plane):
    p = port_plane.port
    st, out, hdrs = http_call(p, "GET", "/nope")
    assert (st, out) == (404, "404: Not Found") and hdrs["ctype"].startswith("text/plain")
    st, out, hdrs = http_call(p, "PATCH", f"{API}/jobs/abc")
    assert (st, out) == (405, "405: Method Not Allowed")
    assert set(hdrs["Allow"].split(",")) == {"DELETE", "GET", "HEAD"}
    st, out, _ = http_call(p, "GET", "/admin")
    assert st == 200 and "<html" in out.lower()
    # a body that is not JSON is a handler failure: 500, the plane lives on
    st, _, _ = http_call(p, "POST", f"{API}/jobs", raw=b"{not json")
    assert st == 500
    assert http_call(p, "GET", "/health")[0] == 200


def test_keep_alive_and_chunked_bodies(port_plane):
    conn = http.client.HTTPConnection("127.0.0.1", port_plane.port, timeout=10)
    try:
        for _ in range(3):
            conn.request("GET", "/health")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["status"]
        body = json.dumps({"type": "llm", "params": {"prompt": "hi"}}).encode()
        conn.request("POST", f"{API}/jobs", body=iter([body[:5], body[5:]]),
                     headers={"Content-Type": "application/json",
                              "Transfer-Encoding": "chunked"}, encode_chunked=True)
        resp = conn.getresponse()
        assert resp.status in (200, 201) and "job_id" in json.loads(resp.read())
    finally:
        conn.close()


def test_a_sync_long_poll_holds_up_no_other_request(port_plane):
    p = port_plane.port
    out: Dict[str, Any] = {}
    # a live worker that never polls: the sync job queues and waits
    st, _, _ = http_call(p, "POST", f"{API}/workers/register", {
        "name": "idle", "machine_fingerprint": "fp-idle", "supported_types": ["llm"]})
    assert st == 200

    def sync_job() -> None:
        t = time.monotonic()
        out["sync"] = http_call(p, "POST", f"{API}/jobs/sync", {
            "type": "llm", "params": {"prompt": "wait"}, "timeout_seconds": 2.0})
        out["sync_s"] = time.monotonic() - t

    th = threading.Thread(target=sync_job)
    th.start()
    time.sleep(0.3)
    t = time.monotonic()
    for _ in range(5):
        assert http_call(p, "GET", "/health")[0] == 200
    assert time.monotonic() - t < 1.0
    th.join(timeout=20)
    assert out["sync_s"] >= 1.5
    # still queued at its deadline: the JAX plane's answer, a 500 naming it
    assert out["sync"][0] == 500 and out["sync"][1]["status"] == "queued"


def test_the_degraded_store_middleware_wraps_every_route(port_plane):
    from distributed_gpu_inference_torch.testing import faults as tfaults

    p = port_plane.port
    with tfaults.active(tfaults.FaultPlan(0, [tfaults.FaultRule(
            site="server.store.execute", kind="error", times=None,
            match={"sql": "INSERT*"})])):
        st, out, hdrs = http_call(p, "POST", f"{API}/workers/register", {
            "name": "x", "machine_fingerprint": "fx", "supported_types": ["llm"]})
        assert st == 503 and out["error_code"] == "store_unavailable"
        assert int(hdrs["Retry-After"]) >= 1
        st, out, _ = http_call(p, "POST", f"{API}/jobs", {"type": "llm",
                                                          "params": {"prompt": "p"}})
        assert st == 503 and out["error_code"] == "store_unavailable"
        assert http_call(p, "GET", f"{API}/jobs/stats/queue")[0] == 200
    assert http_call(p, "POST", f"{API}/jobs", {"type": "llm",
                                                "params": {"prompt": "p"}})[0] in (200, 201)


def test_kill_and_restart_keep_the_port_and_the_jobs(tmp_path):
    with PortPlane(db_path=str(tmp_path / "p.sqlite")) as cp:
        port = cp.port
        st, out, _ = http_call(port, "POST", f"{API}/jobs", {"type": "llm",
                                                             "params": {"prompt": "p"}})
        jid = out["job_id"]
        cp.kill()
        assert not cp.alive
        with pytest.raises(OSError):
            http_call(port, "GET", "/health", timeout=2.0)
        cp.start()
        assert cp.port == port and cp.alive
        assert http_call(port, "GET", f"{API}/jobs/{jid}")[1]["status"] == "queued"
        assert cp.sweep(now=time.time() + 10_000) is not None


def test_the_cli_reports_the_port_it_drew(tmp_path):
    env = {k: v for k, v in os.environ.items()}
    env["PYTHONPATH"] = str(pytest.importorskip("pathlib").Path(__file__).resolve().parents[1])
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_gpu_inference_torch.server.app", "--port", "0",
         "--host", "127.0.0.1", "--db", str(tmp_path / "cli.sqlite")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        line = proc.stdout.readline()
        m = re.search(r"http://127\.0\.0\.1:(\d+)", line)
        assert m, line
        port = int(m.group(1))
        assert port > 0
        assert http_call(port, "GET", "/health")[0] == 200
        mods = subprocess.run([sys.executable, "-c",
                               "import sys, distributed_gpu_inference_torch.server.app; "
                               "print(sorted(m.split('.')[0] for m in sys.modules))"],
                              capture_output=True, text=True, env=env, check=True).stdout
        assert "aiohttp" not in mods and "jax" not in mods
    finally:
        proc.terminate()
        proc.wait(timeout=20)
    assert proc.returncode in (0, -15)
