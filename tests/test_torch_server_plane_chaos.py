"""Replicated control planes of the port under fire: the port copy of
``tests/test_plane_chaos.py``. Its tier-1 cases, each on port planes with
the port's worker client and SDK (and, where the wire allows, on a JAX and
a port plane, or a JAX and a port ``Store``, sharing one store file):
claims racing on two stores, the sweep fencing a stale plane's complete,
stream checkpoints epoch-fenced across planes, the fresh-file migration's
single winner, the forward loop's fence and hop cap, the hostile chain
header, the worker client and the SDK failing over from a dead plane,
``wait_for_job`` across a blip, discovery telling plane loss from "no
worker", the heartbeat's plane identity and the affinity resync after
failover. Then the smoke: Two port planes
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

import asyncio
import random
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.sdk.client import (  # noqa: E402
    InferenceClient,
    InferenceClientError,
)
from distributed_gpu_inference_torch.server.plane_cluster import (  # noqa: E402
    PlaneCluster,
    _parse_chain,
)
from distributed_gpu_inference_torch.server.store import Store  # noqa: E402
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
from distributed_gpu_inference_torch.utils.data_structures import JobStatus  # noqa: E402
from distributed_gpu_inference_torch.worker.api_client import APIClient  # noqa: E402
from distributed_gpu_inference_tpu.server.store import Store as JaxStore  # noqa: E402
from distributed_gpu_inference_tpu.testing.harness import (  # noqa: E402
    LiveControlPlane as JaxLiveControlPlane,
)
from test_torch_fleet_chaos import FLEET_ENGINE, await_quiet, heal, suite_prompts  # noqa: E402

# the two stores of a multi-writer case: port + port, or JAX + port on one file
STORE_PAIRS = {"port+port": (Store, Store), "jax+port": (JaxStore, Store)}
# the plane a client case runs against
PLANES = {"port": LiveControlPlane, "jax": JaxLiveControlPlane}
# a loopback port nothing listens on: connect() fails fast
_DEAD = "http://127.0.0.1:9"


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


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_plane_killed_between_claim_commit_and_answer_strands_the_claim(tmp_path, package):
    """A mirrored fault of the plane protocol, shown on both packages' planes
    with their own worker clients: plane A commits a claim for a worker
    and dies before its answer leaves. The worker fails over to plane B
    with nothing; the job stays ``running`` under that worker, whose
    heartbeats (listing no active jobs) and B's sweeps never requeue it
    before the job's own timeout."""
    import asyncio

    if package == "jax":
        from distributed_gpu_inference_tpu.testing.harness import LiveControlPlane as Plane
        from distributed_gpu_inference_tpu.worker.api_client import APIClient as Client
    else:
        from distributed_gpu_inference_torch.worker.api_client import APIClient as Client

        Plane = LiveControlPlane
    db = str(tmp_path / "jobs.db")
    pa = Plane(db_path=db, plane_id="plane-a", heartbeat_timeout_s=0.9)
    pb = Plane(db_path=db, plane_id="plane-b", heartbeat_timeout_s=0.9)
    pa.start()
    pb.start()
    api = None
    try:
        committed = threading.Event()
        real_claim = pa.state.store.claim_next_job

        async def claim_then_die(*a, **kw):
            job = await real_claim(*a, **kw)
            if job is not None:
                committed.set()
                await asyncio.sleep(3600)      # the answer never leaves
            return job

        pa.state.store.claim_next_job = claim_then_die
        api = Client([pa.url, pb.url], backoff_s=0.0)
        api.register({"name": "w", "region": "us-west", "supported_types": ["llm"]})
        jid = pa.call(pa.state.store.create_job({"type": "llm", "params": {"prompt": "x"}}))
        got: Dict[str, Any] = {}

        def fetch():
            try:
                got["job"] = api.fetch_next_job()
            except Exception as exc:  # noqa: BLE001 — the fetch died with its plane
                got["error"] = exc

        th = threading.Thread(target=fetch, daemon=True)
        th.start()
        assert committed.wait(20.0)
        pa.kill()
        th.join(timeout=60.0)
        assert not th.is_alive() and got.get("job") is None, got
        row = pb.job(jid)
        assert row["status"] == "running" and row["worker_id"] == api.worker_id, row
        assert row["plane_id"] == "plane-a"
        # the worker lives on through plane B, reporting no active job; B
        # sweeps: nothing requeues the claim the worker never heard of
        for _ in range(6):
            api.heartbeat(status="idle", active_job_ids=[])
            pb.call(pb.state.guarantee.sweep())
            time.sleep(0.2)
        row = pb.job(jid)
        assert row["status"] == "running" and row["worker_id"] == api.worker_id, row
    finally:
        if api is not None:
            api.close()
        pa.kill()
        pb.kill()


# ---------------------------------------------------------------------------
# multi-writer store fencing (tests/test_plane_chaos.py:168-314)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", list(STORE_PAIRS))
def test_two_planes_racing_claims_never_double_assign(tmp_path, pair):
    """Two plane replicas (two Store connections on one file) race
    ``claim_next_job`` over a batch of queued jobs: every job is claimed
    once, its epoch bumped once, the winning plane's stamp recorded."""
    db = str(tmp_path / "jobs.db")
    make_a, make_b = STORE_PAIRS[pair]

    async def scenario() -> None:
        sa, sb = make_a(db), make_b(db)
        try:
            n = 16
            for i in range(n):
                await sa.create_job({"type": "llm", "params": {"i": i}})
            claims: List[Dict[str, Any]] = []
            for _ in range(4 * n):
                ja, jb = await asyncio.gather(
                    sa.claim_next_job("w-a", ["llm"], plane_id="plane-a"),
                    sb.claim_next_job("w-b", ["llm"], plane_id="plane-b"))
                claims += [j for j in (ja, jb) if j is not None]
                if ja is None and jb is None:
                    break
            ids = [j["id"] for j in claims]
            assert len(ids) == n and len(set(ids)) == n, "a job was claimed twice"
            assert all(int(j["assignment_epoch"]) == 1 for j in claims)
            rows = await sb.query("SELECT plane_id, COUNT(*) AS c FROM jobs "
                                  "WHERE plane_id IS NOT NULL GROUP BY plane_id", ())
            stamped = {r["plane_id"]: r["c"] for r in rows}
            assert sum(stamped.values()) == n and set(stamped) <= {"plane-a", "plane-b"}
        finally:
            sa.close()
            sb.close()

    asyncio.run(scenario())


@pytest.mark.parametrize("pair", list(STORE_PAIRS))
def test_sweep_requeue_fences_out_stale_plane_complete(tmp_path, pair):
    """Plane B requeues a job claimed through plane A and re-assigns it;
    A's late completion for the old owner loses the ``owned_by`` fence."""
    db = str(tmp_path / "jobs.db")
    make_a, make_b = STORE_PAIRS[pair]

    async def scenario() -> None:
        sa, sb = make_a(db), make_b(db)
        try:
            jid = await sa.create_job({"type": "llm", "params": {}})
            j1 = await sa.claim_next_job("w-1", ["llm"], plane_id="plane-a")
            assert j1 is not None and j1["id"] == jid
            assert await sb.try_transition_job(jid, JobStatus.RUNNING.value,
                                               status=JobStatus.QUEUED.value, worker_id=None)
            j2 = await sb.claim_next_job("w-2", ["llm"], plane_id="plane-b")
            assert j2 is not None and j2["id"] == jid
            assert int(j2["assignment_epoch"]) == int(j1["assignment_epoch"]) + 1
            assert not await sa.try_transition_job(jid, JobStatus.RUNNING.value,
                                                   owned_by="w-1",
                                                   status=JobStatus.COMPLETED.value)
            assert await sa.try_transition_job(jid, JobStatus.RUNNING.value, owned_by="w-2",
                                               status=JobStatus.COMPLETED.value)
            row = (await sb.query("SELECT status, plane_id FROM jobs WHERE id=?", (jid,)))[0]
            assert row["status"] == JobStatus.COMPLETED.value and row["plane_id"] == "plane-b"
        finally:
            sa.close()
            sb.close()

    asyncio.run(scenario())


@pytest.mark.parametrize("pair", list(STORE_PAIRS))
def test_stream_checkpoints_epoch_fenced_across_planes(tmp_path, pair):
    """A checkpoint saved via plane A, adopted via plane B (epoch bump),
    then re-pushed stale via A: the fenced upsert rejects the zombie."""
    db = str(tmp_path / "jobs.db")
    make_a, make_b = STORE_PAIRS[pair]

    async def scenario() -> None:
        sa, sb = make_a(db), make_b(db)
        try:
            assert await sa.save_stream_checkpoint("s1", "w-a", 1, {"tok": 3})
            adopted = await sb.adopt_stream_checkpoint("s1", "w-b")
            assert adopted is not None and int(adopted["epoch"]) == 2
            assert not await sa.save_stream_checkpoint("s1", "w-a", 1, {"tok": 9})
            assert await sa.save_stream_checkpoint("s1", "w-b", 2, {"tok": 5})
            assert (await sb.get_stream_checkpoint("s1"))["state"] == {"tok": 5}
        finally:
            sa.close()
            sb.close()

    asyncio.run(scenario())


@pytest.mark.parametrize("pair", list(STORE_PAIRS))
def test_concurrent_fresh_file_migration_is_single_winner(tmp_path, pair):
    """Two planes open a fresh db file at once: both constructors succeed
    (the per-version transaction re-checks ``user_version``)."""
    db = str(tmp_path / "fresh.db")
    stores: List[Any] = []
    errors: List[BaseException] = []

    def build(make) -> None:
        try:
            stores.append(make(db))
        except BaseException as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    threads = [threading.Thread(target=build, args=(m,)) for m in STORE_PAIRS[pair]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not errors, errors
    assert len(stores) == 2

    async def check() -> None:
        ver = await stores[0].query("PRAGMA user_version", ())
        assert ver[0]["user_version"] >= 10

    asyncio.run(check())
    for st in stores:
        st.close()


# ---------------------------------------------------------------------------
# plane forwarding: loop fence and hop cap (tests/test_plane_chaos.py:317-338)
# ---------------------------------------------------------------------------


def test_forward_loop_fence_and_hop_cap():
    pc = PlaneCluster(plane_id="plane-x", peers=["http://peer:1"], forward_max_hops=2)
    assert pc.enabled
    assert pc.may_forward([]) and pc.may_forward(["plane-y"])
    assert not pc.may_forward(["plane-x"])
    assert not pc.may_forward(["plane-y", "plane-x"])
    assert pc.stats["loop_fenced"] == 2
    assert not pc.may_forward(["plane-y", "plane-z"])        # the hop cap
    off = PlaneCluster()
    assert not off.enabled and not off.may_forward([])


def test_parse_chain_bounds_hostile_header():
    assert _parse_chain(None) == []
    assert _parse_chain("a, b ,c") == ["a", "b", "c"]
    assert len(_parse_chain(",".join(f"p{i}" for i in range(99)))) <= 16


# ---------------------------------------------------------------------------
# client failover: the port's worker client and SDK (tests/test_plane_chaos.py:412-474)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", list(PLANES))
def test_worker_api_client_fails_over_from_dead_plane(plane):
    with PLANES[plane]() as cp:
        api = APIClient([_DEAD, cp.url], backoff_s=0.0)
        api.register({"name": "w", "region": "us-west", "supported_types": ["llm"]})
        assert api.worker_id and api.plane_failovers == 1
        # sticky: the next call starts on the survivor, no re-probe churn
        assert api.base_url == cp.url
        api.heartbeat(status="idle")
        assert api.plane_failovers == 1
        api.close()


@pytest.mark.parametrize("plane", list(PLANES))
def test_sdk_create_job_fails_over_on_connect_error(plane):
    """A connection refused before the request was sent cannot have
    created the job: the next endpoint takes the submission."""
    with PLANES[plane]() as cp:
        c = InferenceClient([_DEAD, cp.url], backoff_s=0.0, max_retries=0)
        job_id = c.create_job("llm", {"prompt": "x"})
        assert cp.job(job_id) is not None
        c.close()


@pytest.mark.parametrize("plane", list(PLANES))
def test_sdk_wait_for_job_survives_plane_blip(plane):
    with PLANES[plane]() as cp:
        c = InferenceClient([_DEAD, cp.url], backoff_s=0.0, max_retries=0)
        job_id = c.create_job("llm", {"prompt": "x"})
        cp.call(cp.state.store.try_transition_job(job_id, JobStatus.QUEUED.value,
                                                  status=JobStatus.COMPLETED.value,
                                                  result={"text": "done"}))
        job = c.wait_for_job(job_id, timeout_s=10.0, poll_s=0.05)
        assert job["status"] == "completed"
        c.close()


@pytest.mark.parametrize("plane", list(PLANES))
def test_sdk_discovery_distinguishes_plane_loss_from_no_worker(plane):
    """``_get_nearest_worker`` tells every endpoint unreachable (raised with
    ``raise_plane_errors``) from a plane's answer of no worker (None)."""
    dead = InferenceClient([_DEAD], backoff_s=0.0, max_retries=0)
    try:
        assert dead._get_nearest_worker() is None
        with pytest.raises(InferenceClientError) as info:
            dead._get_nearest_worker(raise_plane_errors=True)
        assert info.value.status >= 500
    finally:
        dead.close()
    with PLANES[plane]() as cp:
        live = InferenceClient(cp.url, backoff_s=0.0, max_retries=0)
        try:
            assert live._get_nearest_worker(raise_plane_errors=True) is None
        finally:
            live.close()


# ---------------------------------------------------------------------------
# the live multi-plane fleet (tests/test_plane_chaos.py:646-718)
# ---------------------------------------------------------------------------


def test_heartbeat_carries_plane_identity(fleet):
    api = APIClient(fleet.plane_urls, backoff_s=0.0)
    api.register({"name": "hb-probe", "region": "us-west", "supported_types": ["llm"]})
    assert api.heartbeat(status="idle").get("plane_id") == "plane-0"
    api.close()


def test_affinity_resyncs_within_one_roundtrip_after_failover(fleet):
    """After a worker fails over to another plane, the prefix-summary delta
    protocol sees the plane identity change and pushes a full snapshot:
    affinity on the new plane converges within heartbeats, not at the
    staleness TTL."""
    from distributed_gpu_inference_torch.utils.prefixes import prefix_fingerprints

    shared = "failover prefix " + "z" * 120
    fps = prefix_fingerprints(shared)
    assert fps
    c = InferenceClient(fleet.plane_urls, backoff_s=0.05)
    try:
        first = c.chat(prompt=shared + " tail0", max_new_tokens=4, use_direct=True,
                       prefix_hint=shared)
        assert first.get("text") is not None
        deadline = time.time() + 5.0
        warm: List[Any] = []
        while time.time() < deadline and not warm:
            warm = [(m, p) for m in fleet.members for p in fleet.planes
                    if m.api.base_url == p.url
                    and p.state.prefix_registry.affinity(m.worker_id, fps) > 0.0]
            time.sleep(0.05)
        assert warm, "no worker advertised the shared prefix to its plane"
        target, active = warm[0]
        other = next(p for p in fleet.planes if p is not active)
        before = target.worker.stats.get("plane_failovers", 0)
        active.kill()
        try:
            # the new plane may apply the beat's summary a moment before the
            # worker reads the answer that counts its failover: wait for both
            reg = other.state.prefix_registry
            deadline = time.time() + 8.0
            while time.time() < deadline and (
                    reg.affinity(target.worker_id, fps) <= 0.0
                    or target.worker.stats.get("plane_failovers", 0) <= before):
                time.sleep(0.05)
            assert reg.affinity(target.worker_id, fps) > 0.0, \
                "the full summary never reached the failover plane"
            assert target.worker.stats.get("plane_failovers", 0) > before
        finally:
            active.start()
            heal(fleet)
    finally:
        c.close()
