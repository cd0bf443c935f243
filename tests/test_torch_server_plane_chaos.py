"""Replicated control planes of the port under fire: the port copy of
``tests/test_plane_chaos.py``'s tier-1 smoke. Two port planes
(``server/app.py`` behind the port's ``LiveControlPlane``) share one sqlite
job store, each stamping the claims it brokers with its ``plane_id``; two
port workers (``TorchLLMEngine``, ``llama3-tiny``, f32, CPU) and the port's
SDK hold both endpoints. Plane 0 is hard-killed and restarted while a small
open-loop workload runs: nothing lost, every claim plane-stamped, outputs
byte-identical to a calm replay through one plane, and a worker failed
over. The plane-to-plane forwarding runs over the port's ``http.client``
forwarder.

The smoke carries ``slow`` and ``plane_chaos``: under CPU contention it
can time out waiting for a job that stays ``running``. The plane's protocol
(the JAX plane's, carried over) allows that: a plane killed after its claim
transaction committed but before its answer left leaves the job
``running`` on a live worker that never received it; the worker keeps
heartbeating, so no sweep requeues the job before its own timeout (300 s).
A heartbeat's ``active_job_ids`` fence claims that are no longer the
worker's, not claims the worker never heard of.
"""

import random
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.sdk.client import InferenceClient  # noqa: E402
from distributed_gpu_inference_torch.testing.faults import (  # noqa: E402
    PLANE_CHAOS_KINDS,
    PLANE_CHAOS_PLANES,
    PLANE_CHAOS_WORKERS,
    FleetEvent,
    FleetFaultPlan,
)
from distributed_gpu_inference_torch.testing.harness import (  # noqa: E402
    FleetWorker,
    LiveControlPlane,
    LiveFleet,
)
from test_torch_fleet_chaos import FLEET_ENGINE, await_quiet, heal, suite_prompts  # noqa: E402


@pytest.fixture(scope="module")
def fleet():
    with tempfile.TemporaryDirectory(prefix="dgi-torch-planes-") as d:
        planes = [LiveControlPlane(db_path=f"{d}/jobs.db", heartbeat_timeout_s=0.9,
                                   plane_id=f"plane-{i}")
                  for i in range(PLANE_CHAOS_PLANES)]
        with LiveFleet(n=PLANE_CHAOS_WORKERS, planes=planes, member_factory=lambda i, urls, role:
                       FleetWorker(i, urls, FLEET_ENGINE),
                       on_event=lambda k: planes[-1].state.metrics.record_chaos_event(k)) as f:
            yield f


def drive_open_loop(fleet: LiveFleet, prompts: List[str], seed: int, max_tokens: int,
                    rate: float = 2.5, stream_every: int = 3) -> List[Dict[str, Any]]:
    """The JAX suite's open loop: every client holds the FULL plane
    endpoint list while planes die under it."""
    rng = random.Random(seed * 107 + 9)
    arrivals, t = [], 0.0
    for _ in prompts:
        t += rng.expovariate(rate)
        arrivals.append(t)
    results: List[Optional[Dict[str, Any]]] = [None] * len(prompts)
    errors: List[BaseException] = []
    t0 = time.monotonic()
    urls = fleet.plane_urls

    def one(i: int, prompt: str) -> None:
        wait = arrivals[i] - (time.monotonic() - t0)
        if wait > 0:
            time.sleep(wait)
        c = InferenceClient(urls, backoff_s=0.05)
        try:
            if i % stream_every == stream_every - 1:
                chunks = list(c.stream_chat(prompt=prompt, max_new_tokens=max_tokens,
                                            timeout_s=90.0, max_stream_resumes=6))
                assert chunks[-1].get("done") is True, (prompt, chunks[-1:])
                offs = [int(ch["offset"]) for ch in chunks if ch.get("offset") is not None]
                assert offs == sorted(offs), (prompt, offs)
                results[i] = {"prompt": prompt, "path": "stream",
                              "text": "".join(ch.get("text_delta") or "" for ch in chunks[:-1])}
            else:
                job_id = c.create_job("llm", {"prompt": prompt, "max_new_tokens": max_tokens})
                job = c.wait_for_job(job_id, timeout_s=90.0, poll_s=0.05)
                assert job["status"] == "completed", (prompt, job)
                results[i] = {"prompt": prompt, "path": "queued",
                              "text": job["result"]["text"]}
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)
        finally:
            c.close()

    threads = [threading.Thread(target=one, args=(i, p), daemon=True)
               for i, p in enumerate(prompts)]
    for t_ in threads:
        t_.start()
    for t_ in threads:
        t_.join(timeout=120.0)
    if errors:
        raise errors[0]
    lost = [prompts[i] for i, r in enumerate(results) if r is None]
    assert not lost, f"lost requests: {lost}"
    return results  # type: ignore[return-value]


@pytest.mark.slow
@pytest.mark.plane_chaos
def test_port_plane_smoke_kill_one_plane_under_load(fleet):
    plan = FleetFaultPlan(0, n_workers=PLANE_CHAOS_WORKERS, kinds=PLANE_CHAOS_KINDS,
                          n_planes=PLANE_CHAOS_PLANES, duration_s=2.5)
    plan.events = [FleetEvent(0.3, "plane_kill", 0), FleetEvent(1.8, "plane_restart", 0)]
    prompts = suite_prompts(0, 5)
    fleet.run_chaos(plan)
    try:
        records = drive_open_loop(fleet, prompts, seed=0, max_tokens=5, rate=3.0)
    finally:
        fleet.wait_chaos()
        heal(fleet)
    assert [k for _, k, _ in plan.trace] == ["plane_kill", "plane_restart"]
    await_quiet(fleet)
    rows = fleet.any_plane().query("SELECT id, status, result, plane_id FROM jobs", ())
    assert rows and all(r["status"] == "completed" and r["result"] for r in rows), rows
    assert all(r["plane_id"] for r in rows), rows
    c = InferenceClient(fleet.any_plane().url, backoff_s=0.05)
    try:
        for rec in records:
            job = c.wait_for_job(c.create_job("llm", {"prompt": rec["prompt"],
                                                      "max_new_tokens": 5}),
                                 timeout_s=90.0, poll_s=0.05)
            assert job["status"] == "completed" and job["result"]["text"] == rec["text"], rec
    finally:
        c.close()
    assert all(p.alive for p in fleet.planes)
    assert sum(m.api.plane_failovers for m in fleet.members) >= 1


def test_a_saturated_port_plane_forwards_to_its_peer(tmp_path):
    """Plane-to-plane forwarding over the port's forwarder: a plane past
    its queue limit hands the submission to its peer, which queues it."""
    from distributed_gpu_inference_torch.worker.api_client import APIClient

    db = str(tmp_path / "jobs.db")
    with LiveControlPlane(db_path=db, plane_id="p1") as p1, \
            LiveControlPlane(db_path=db, plane_id="p0") as p0:
        p0.state.plane.peers = [p1.url]
        p1.state.plane.peers = [p0.url]
        api = APIClient(p1.url, backoff_s=0.0)
        api.register({"name": "w", "machine_fingerprint": "fwd",
                      "supported_types": ["llm"]})
        api.heartbeat(status="idle")
        # p0 backpressures at one queued job; p1 takes any
        p0.state.worker_config.set_submit_queue_limit(1)
        c = InferenceClient(p0.url, backoff_s=0.0, max_retries=0)
        try:
            c.create_job("llm", {"prompt": "first"})
            jid = c.create_job("llm", {"prompt": "second"})
        finally:
            c.close()
        job = p1.job(jid)
        assert job is not None and job["status"] == "queued"
        assert p0.state.plane.stats["forwarded"] == 1
        assert p1.state.plane.stats["received_forwarded"] == 1
