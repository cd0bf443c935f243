"""Fleet under fire, on port workers: the worker and fleet scenarios of
``tests/test_fleet_chaos.py`` run on a :class:`LiveFleet` of the PyTorch
port (``distributed_gpu_inference_torch/testing/harness.py``) — real port
``Worker``s with ``TorchLLMEngine`` (``llama3-tiny``, f32, CPU), the
port's ``DirectServer`` and heartbeat / poll threads — behind either
plane: the JAX package's ``LiveControlPlane`` with the JAX SDK's
``InferenceClient``, or the port's own ``LiveControlPlane`` with the port's
SDK (the fleet fixture and the tier-1 cases run on both). The same seeds,
token budgets and invariants as the JAX twins:

- no lost or duplicated work (every job COMPLETED once, every stream ends
  with ``done`` and gapless, monotonic offsets);
- greedy text byte-identical to a calm replay on the same fleet;
- 429 + Retry-After once the queue saturates behind a shrunken fleet;
- a partitioned worker's prefix affinity is zeroed and discovery spills to
  the live one; the plane's chaos counters see every event.

The plane-only fencing tests of the JAX file have no worker in them and
are not repeated here; the schedule's parity with the JAX generator is in
``tests/test_torch_fleet_plan.py``. The smoke stays in tier-1, the rest
carry ``slow`` + ``fleet_chaos`` as their twins do.
"""

import random
import threading
import time
from typing import Any, Dict, List, Optional

import httpx
import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.testing.faults import (  # noqa: E402
    FleetEvent,
    FleetFaultPlan,
)
from distributed_gpu_inference_torch.sdk import client as tsdk  # noqa: E402
from distributed_gpu_inference_torch.testing.harness import (  # noqa: E402
    DEFAULT_FLEET_ENGINE,
    FleetWorker,
    LiveFleet,
)
from distributed_gpu_inference_torch.testing.harness import (  # noqa: E402
    LiveControlPlane as PortControlPlane,
)
from distributed_gpu_inference_tpu.sdk import client as jsdk  # noqa: E402
from distributed_gpu_inference_tpu.testing import faults as jfaults  # noqa: E402
from distributed_gpu_inference_tpu.testing.harness import LiveControlPlane  # noqa: E402
from distributed_gpu_inference_tpu.utils.data_structures import JobStatus  # noqa: E402

# the two planes a port fleet runs behind, each with its own package's SDK
PLANES = ("jax", "port")

N_SEEDS = 25

# the JAX suite's geometry (deep preemption budget, per-token checkpoints)
# on the CPU, in f32
FLEET_ENGINE = {
    **DEFAULT_FLEET_ENGINE,
    "serving": {**DEFAULT_FLEET_ENGINE["serving"], "max_preemptions": 8},
    "device": "cpu",
    "dtype": "float32",
}


def port_fleet(n: int = 2, engine_config: Optional[Dict[str, Any]] = None,
               heartbeat_timeout_s: float = 0.9, submit_queue_limit: int = 0,
               plane_kw: Optional[Dict[str, Any]] = None, plane: str = "jax",
               **kw: Any) -> LiveFleet:
    """A port fleet behind a ``LiveControlPlane`` (the JAX harness's
    defaults) — the JAX package's (``plane="jax"``, plane-side fault rules
    armed in the JAX registry) or the port's own (``plane="port"``, whose
    seams are the port's) — chaos events recorded in the plane's metrics."""
    box: List[LiveFleet] = []
    cls = LiveControlPlane if plane == "jax" else PortControlPlane

    def make_plane() -> Any:
        return cls(heartbeat_timeout_s=heartbeat_timeout_s,
                   submit_queue_limit=submit_queue_limit, **(plane_kw or {}))

    fl = LiveFleet(
        n=n, engine_config=engine_config or FLEET_ENGINE, plane_factory=make_plane,
        plane_faults=jfaults if plane == "jax" else None,
        on_event=lambda k: box[0].plane.state.metrics.record_chaos_event(k),
        **kw,
    )
    box.append(fl)
    return fl


def sdk(fleet: LiveFleet) -> Any:
    """The SDK module of the fleet's plane's package."""
    return tsdk if isinstance(fleet.plane, PortControlPlane) else jsdk


def client(fleet: LiveFleet, **kw: Any) -> Any:
    """An ``InferenceClient`` of the fleet's plane's package on its URL."""
    return sdk(fleet).InferenceClient(fleet.url, **kw)


def paced(member_cls: Any, pace: Dict[str, float], capacity: Optional[int] = None,
          rounds: tuple = ("ragged_round", "decode_multi")) -> Any:
    """``member_cls`` (a fleet member class of either package) whose engine
    ``rounds`` each sleep ``pace["s"]`` first — a service time a scenario
    needs (a kill landing mid-generation, a latency SLO) on the CPU, where
    the tiny model otherwise answers in milliseconds — and whose worker
    takes ``capacity`` shared claims."""

    class Paced(member_cls):
        def start(self) -> None:
            super().start()
            if capacity is not None:
                self.worker.config.load_control.max_concurrent_jobs = capacity
            eng = self.llm.engine
            for name in rounds:
                real = getattr(eng, name)

                def slow(*a: Any, _real: Any = real, **kw: Any) -> Any:
                    time.sleep(pace["s"])
                    return _real(*a, **kw)

                setattr(eng, name, slow)

    return Paced


def metric(plane: Any, name: str) -> str:
    text = httpx.get(f"{plane.url}/metrics").text
    return "\n".join(line for line in text.splitlines() if line.startswith(name))


# ---------------------------------------------------------------------------
# live-fleet workload driver (the JAX suite's, on port members)
# ---------------------------------------------------------------------------


def suite_prompts(seed: int, n: int) -> List[str]:
    rng = random.Random(seed * 31 + 17)
    return [
        f"s{seed}r{i} " + "".join(chr(97 + rng.randrange(26)) for _ in range(10))
        for i in range(n)
    ]


def drive_open_loop(fleet: LiveFleet, prompts: List[str], seed: int,
                    max_tokens: int, rate: float = 2.5,
                    stream_every: int = 3) -> List[Dict[str, Any]]:
    """Open-loop Poisson workload: queued jobs through the plane, every
    ``stream_every``-th request a direct SSE stream (exactly-once offsets
    through kills). One record per request: {prompt, text, path}. Raises
    on any lost request."""
    rng = random.Random(seed * 101 + 3)
    arrivals, t = [], 0.0
    for _ in prompts:
        t += rng.expovariate(rate)
        arrivals.append(t)
    results: List[Optional[Dict[str, Any]]] = [None] * len(prompts)
    errors: List[BaseException] = []
    t0 = time.monotonic()

    def queued(i: int, prompt: str) -> None:
        c = client(fleet, backoff_s=0.05)
        try:
            job_id = c.create_job("llm", {"prompt": prompt, "max_new_tokens": max_tokens})
            job = c.wait_for_job(job_id, timeout_s=90.0, poll_s=0.05)
            assert job["status"] == "completed", (prompt, job)
            results[i] = {"prompt": prompt, "path": "queued",
                          "text": job["result"]["text"], "job_id": job_id}
        finally:
            c.close()

    def streamed(i: int, prompt: str) -> None:
        c = client(fleet, backoff_s=0.05)
        try:
            chunks = list(c.stream_chat(prompt=prompt, max_new_tokens=max_tokens,
                                        timeout_s=90.0, max_stream_resumes=6))
            assert chunks[-1].get("done") is True, (prompt, chunks[-1:])
            text = "".join(ch.get("text_delta") or "" for ch in chunks[:-1])
            # exactly-once SSE across failovers: offsets monotonic, and the
            # consumed token count equals the final offset
            offs = [int(ch["offset"]) for ch in chunks if ch.get("offset") is not None]
            assert offs == sorted(offs), (prompt, offs)
            toks = [t for ch in chunks[:-1] for t in ch.get("token_ids") or []]
            if offs:
                assert len(toks) == offs[-1], (prompt, len(toks), offs)
            results[i] = {"prompt": prompt, "path": "stream", "text": text}
        finally:
            c.close()

    def one(i: int, prompt: str) -> None:
        wait = arrivals[i] - (time.monotonic() - t0)
        if wait > 0:
            time.sleep(wait)
        try:
            if i % stream_every == stream_every - 1:
                streamed(i, prompt)
            else:
                queued(i, prompt)
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

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


def await_quiet(fleet: LiveFleet, timeout_s: float = 20.0) -> None:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if all(m.engine_quiet() for m in fleet.members):
            return
        time.sleep(0.05)
    raise AssertionError(
        f"engines not quiet: {[(m.tag, m.engine_quiet()) for m in fleet.members]}")


def assert_no_lost_or_duplicated_jobs(fleet: LiveFleet) -> None:
    rows = fleet.plane.query("SELECT id, status, result FROM jobs", ())
    bad = [r for r in rows if r["status"] != JobStatus.COMPLETED.value]
    assert not bad, f"non-terminal/failed jobs: {bad}"
    empty = [r["id"] for r in rows if not r["result"]]
    assert not empty, f"completed without a result: {empty}"


def calm_reference(fleet: LiveFleet, records: List[Dict[str, Any]],
                   max_tokens: int) -> None:
    """Replay every prompt on the healthy fleet WITHOUT chaos: greedy text
    byte-identical (resume, splice and preempt/resume compose)."""
    c = client(fleet, backoff_s=0.05)
    try:
        for rec in records:
            job_id = c.create_job("llm", {"prompt": rec["prompt"],
                                          "max_new_tokens": max_tokens})
            job = c.wait_for_job(job_id, timeout_s=90.0, poll_s=0.05)
            assert job["status"] == "completed", rec
            calm = job["result"]["text"]
            assert rec["text"] == calm, (rec["prompt"], rec["path"], rec["text"], calm)
    finally:
        c.close()


def heal(fleet: LiveFleet) -> None:
    """Post-chaos: every member alive (a driver failure must not cascade
    into the next seed)."""
    for m in fleet.members:
        if not m.alive:
            m.start()


# ---------------------------------------------------------------------------
# the tier-1 smoke: 2 workers, 1 kill, tiny token budget
# ---------------------------------------------------------------------------


# the module fleet's engine rounds sleep PACE["s"] first (0 outside the smoke)
PACE = {"s": 0.0}


@pytest.fixture(scope="module", params=PLANES)
def fleet(request):
    member = paced(FleetWorker, PACE)
    with port_fleet(n=2, plane=request.param,
                    member_factory=lambda i, url, role: member(i, url, FLEET_ENGINE)) as f:
        yield f


def test_fleet_smoke_kill_one_worker_under_load(fleet):
    """One hard kill + restart of a port worker while a small open-loop
    workload runs: the kill lands while the victim holds a running job
    (rounds paced 0.3 s, so a 5-token job outlasts its detection), which
    is requeued and completes on the other member; nothing lost, outputs
    byte-identical to the calm fleet, the restarted member back on its own
    plane row.

    Member 1 claims nothing until member 0 holds a running job: the member
    that polls first could otherwise take every queued job of the
    workload, and member 0 would hold none to be killed with."""
    wid = fleet.members[0].worker_id
    other = fleet.members[1].worker
    hold, held_polls = threading.Event(), []
    real_poll = other._poll_once

    def held_poll() -> bool:
        if hold.is_set():
            held_polls.append(1)
            return False
        return real_poll()

    prompts = suite_prompts(0, 5)
    out: Dict[str, Any] = {}
    errors: List[BaseException] = []

    def traffic() -> None:
        try:
            out["records"] = drive_open_loop(fleet, prompts, seed=0, max_tokens=5, rate=3.0)
        except BaseException as exc:  # noqa: BLE001 — raised below
            errors.append(exc)

    plan = FleetFaultPlan(0, n_workers=2, duration_s=2.0)
    plan.events = [FleetEvent(0.0, "kill", 0), FleetEvent(1.2, "restart", 0)]
    PACE["s"] = 0.3
    t = threading.Thread(target=traffic, daemon=True)
    hold.set()
    other._poll_once = held_poll
    try:
        # the poll loop is sequential: once it has called the held poll
        # twice, no poll it began before the hold is still in flight
        deadline = time.time() + 30.0
        while len(held_polls) < 2:
            assert time.time() < deadline, "member 1's poll loop did not pause"
            time.sleep(0.01)
        t.start()
        held: List[str] = []
        deadline = time.time() + 60.0
        while not held:
            assert time.time() < deadline, "member 0 never held a running job"
            held = [r["id"] for r in fleet.plane.query(
                "SELECT id FROM jobs WHERE status='running' AND worker_id=?", (wid,))]
            time.sleep(0 if held else 0.02)
        hold.clear()
        fleet.run_chaos(plan)
    finally:
        hold.clear()
        del other._poll_once
        if t.is_alive():
            t.join(timeout=120.0)
        fleet.wait_chaos()
        heal(fleet)
        PACE["s"] = 0.0
    if errors:
        raise errors[0]
    records = out["records"]
    assert [k for _, k, _ in plan.trace] == ["kill", "restart"]
    assert fleet.members[0].worker_id == wid
    # the victim's running jobs were requeued and claimed again elsewhere
    requeued = [j for j in held if fleet.plane.job(j)["assignment_epoch"] >= 2]
    assert requeued, [fleet.plane.job(j) for j in held]
    await_quiet(fleet)
    assert_no_lost_or_duplicated_jobs(fleet)
    calm_reference(fleet, records, max_tokens=5)
    assert "chaos_kills_total 1.0" in metric(fleet.plane, "chaos_kills_total")


# ---------------------------------------------------------------------------
# the 25-seed suite and the live-fleet scenarios (slow + fleet_chaos)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.fleet_chaos
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_fleet_chaos_seeded(fleet, seed):
    """One seeded replay (kill/partition/blackout/pressure/slow) under an
    open-loop queued + stream workload; the composed invariants hold."""
    plan = FleetFaultPlan(seed)
    assert plan.events == FleetFaultPlan(seed).events   # determinism
    prompts = suite_prompts(seed, 9)
    fleet.run_chaos(plan)
    try:
        records = drive_open_loop(fleet, prompts, seed=seed, max_tokens=7)
    finally:
        fleet.wait_chaos(timeout_s=180.0)
        heal(fleet)
    assert [k for _, k, _ in plan.trace] == [e.kind for e in plan.events]
    await_quiet(fleet)
    assert_no_lost_or_duplicated_jobs(fleet)
    calm_reference(fleet, records, max_tokens=7)
    assert all(m.alive for m in fleet.members)


@pytest.mark.slow
@pytest.mark.fleet_chaos
@pytest.mark.parametrize("plane", PLANES)
def test_fleet_backpressure_engages_when_capacity_shrinks(plane):
    """Kill one of two port replicas, flood the queue past
    submit_queue_limit: 429 + Retry-After; accepted jobs still complete and
    the restarted replica re-absorbs load."""
    with port_fleet(n=2, submit_queue_limit=3, plane=plane) as fl:
        fl.members[0].kill()
        fl.plane.state.metrics.record_chaos_event("kill")
        client_error = sdk(fl).InferenceClientError
        c = client(fl, backoff_s=0.0, max_retries=0)
        rejected, accepted = 0, []
        try:
            for i in range(14):
                try:
                    accepted.append(c.create_job(
                        "llm", {"prompt": f"bp{i} abcdefgh", "max_new_tokens": 4}))
                except client_error as exc:
                    assert exc.status == 429
                    assert exc.retry_after_s is not None and exc.retry_after_s > 0
                    rejected += 1
            assert rejected >= 1, "queue never saturated"
            assert accepted, "every submission rejected"
            fl.members[0].start()
            for job_id in accepted:
                job = c.wait_for_job(job_id, timeout_s=120.0, poll_s=0.05)
                assert job["status"] == "completed", job
        finally:
            c.close()
        served_by = {r["worker_id"] for r in fl.plane.query(
            "SELECT worker_id FROM jobs WHERE status=?", (JobStatus.COMPLETED.value,))}
        assert fl.members[0].worker_id in served_by or len(served_by) >= 1
        assert "rejected" in metric(fl.plane, "inference_requests_total")


@pytest.mark.slow
@pytest.mark.fleet_chaos
@pytest.mark.parametrize("plane", PLANES)
def test_partitioned_worker_loses_prefix_affinity_live(plane):
    """Requests sharing a prefix warm one port worker's radix summary; a
    partition takes it out; discovery for the prefix lands on the other
    replica while the partition holds, and the invalidation is counted."""
    from distributed_gpu_inference_tpu.utils.prefixes import prefix_fingerprints

    with port_fleet(n=2, plane=plane) as fl:
        shared = "shared prefix " + "q" * 120
        c = client(fl, backoff_s=0.05)
        try:
            fps = prefix_fingerprints(shared)
            assert fps
            first = c.chat(prompt=shared + " tail0", max_new_tokens=4,
                           use_direct=True, prefix_hint=shared)
            assert first.get("text") is not None
            time.sleep(0.6)   # ≥ 2 heartbeats: the summary reaches the plane
            reg = fl.plane.state.prefix_registry
            warm = [m for m in fl.members if reg.affinity(m.worker_id, fps) > 0.0]
            assert warm, "no worker advertised the shared prefix"
            target = warm[0]
            other = next(m for m in fl.members if m is not target)

            plan = FleetFaultPlan(0, n_workers=2, duration_s=3.0)
            plan.events = [FleetEvent(0.0, "partition", target.index, duration_s=2.5)]
            fl.run_chaos(plan)
            try:
                deadline = time.time() + 2.0
                while time.time() < deadline and \
                        reg.affinity(target.worker_id, fps) > 0.0:
                    time.sleep(0.05)
                assert reg.affinity(target.worker_id, fps) == 0.0
                r = httpx.get(f"{fl.url}/api/v1/jobs/direct/nearest",
                              params={"prefix_fps": ",".join(fps)})
                assert r.status_code == 200
                assert r.json()["worker_id"] == other.worker_id
            finally:
                fl.wait_chaos()
            assert "prefix_summaries_invalidated_total" in metric(
                fl.plane, "prefix_summaries_invalidated_total")
            assert "chaos_partitions_total 1.0" in metric(fl.plane, "chaos_partitions_total")
        finally:
            c.close()


# ---------------------------------------------------------------------------
# the harness's members on their own (tier-1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", PLANES)
def test_fake_members_complete_jobs_through_a_kill_and_restart(plane):
    """Engine-free members on the port's APIClient: every queued job
    completes once through a kill + restart, and the restart keeps its
    plane row."""
    with port_fleet(n=2, fake_engines=True, plane=plane) as fl:
        wid = fl.members[0].worker_id
        plan = FleetFaultPlan(0, n_workers=2, duration_s=1.0)
        plan.events = [FleetEvent(0.1, "kill", 0), FleetEvent(0.6, "restart", 0)]
        fl.run_chaos(plan)
        c = client(fl, backoff_s=0.05)
        try:
            jids = [c.create_job("llm", {"prompt": f"fake {i}"}) for i in range(6)]
            fl.wait_chaos()
            done = [c.wait_for_job(j, timeout_s=30.0, poll_s=0.05) for j in jids]
        finally:
            c.close()
        assert [d["status"] for d in done] == ["completed"] * 6
        assert {d["result"]["text"] for d in done} == {f"fake:{j}" for j in jids}
        assert fl.members[0].worker_id == wid and fl.members[0].alive
        assert sum(m.completed for m in fl.members) == 6
        assert [k for _, k, _ in plan.trace] == ["kill", "restart"]


@pytest.mark.parametrize("plane", PLANES)
def test_member_weights_hook_and_pd_data_plane(plane):
    """A member's weights come from a numpy tree (every restart converts it
    again); a PD member serves its worker's KV
    data plane on a free port and registers it; a killed member's client
    refuses every call, so nothing of the dead incarnation reaches the
    plane."""
    from distributed_gpu_inference_torch.models.convert import params_to_numpy
    from distributed_gpu_inference_torch.worker.api_client import APIError

    with (LiveControlPlane if plane == "jax" else PortControlPlane)() as cp:
        m = FleetWorker(0, cp.url, FLEET_ENGINE, pd_data_plane=True, role="decode")
        m.start()
        try:
            tree = params_to_numpy(m.llm.engine.params)
            row = cp.worker(m.worker_id)
            url = row["data_plane_url"]
            assert url == f"http://127.0.0.1:{m.worker._pd_plane.port}"
            assert httpx.get(url + "/health").json()["pd_kv_receiver"] is True
            api = m.api
        finally:
            m.kill()
        with pytest.raises(APIError) as ei:
            api.heartbeat(status="idle")
        assert ei.value.status == 599
        assert m.worker is None and m.llm is None
        m.weights = tree
        m.start()
        try:
            got = params_to_numpy(m.llm.engine.params)
            assert all((got["layers"][k] == tree["layers"][k]).all() for k in tree["layers"])
            assert cp.worker(m.worker_id)["id"] == m.worker_id
        finally:
            m.stop()
