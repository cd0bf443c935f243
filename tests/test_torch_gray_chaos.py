"""Gray failures on port workers: the fleet scenarios of
``tests/test_gray_chaos.py`` on a 3-replica port ``LiveFleet``
(``TorchLLMEngine`` ``llama3-tiny``, f32, CPU) behind the JAX package's
``LiveControlPlane`` with its health quarantine live, the JAX SDK as the
client. A replica that heartbeats on time while answering slow
(``degrade``), noisily slow (``jitter``) or 5xx at a probability
(``flaky``) — through the port ``DirectServer``'s seams — composed with
clean kills: nothing lost, exactly-once stream offsets, outputs
byte-identical to a calm replay; and a degraded port replica is walked by
the plane from healthy through quarantine and probation back to healthy
off the latency samples its heartbeats ship.

Both carry ``slow`` + ``gray_chaos`` as their twins do; the schedule,
health-service, batcher, hedge and SDK tests there have no fleet in them
(the schedule's parity is ``tests/test_torch_fleet_plan.py``).
"""

import contextlib
import time
from typing import Any, Optional

import httpx
import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.testing.faults import (  # noqa: E402
    GRAY_CHAOS_KINDS,
    GRAY_CHAOS_WORKERS,
    FleetEvent,
    FleetFaultPlan,
)
from distributed_gpu_inference_tpu.server.health import (  # noqa: E402
    HEALTHY,
    PROBATION,
    QUARANTINED,
    SUSPECT,
)
from tests.test_torch_fleet_chaos import (  # noqa: E402
    FLEET_ENGINE,
    assert_no_lost_or_duplicated_jobs,
    await_quiet,
    calm_reference,
    drive_open_loop,
    heal,
    metric,
    port_fleet,
    suite_prompts,
)

N_SEEDS = 25

# the JAX suite's thresholds: judged after 4 samples, escalation after
# 0.3 s of suspicion, probation 3 s into quarantine
GRAY_HEALTH = dict(enabled=True, window_s=20.0, min_samples=4, min_peers=2,
                   suspect_ratio=3.0, clear_ratio=1.5, grace_s=0.3,
                   probation_after_s=3.0, canary_budget=4)


def _gray_plan(seed: int) -> FleetFaultPlan:
    return FleetFaultPlan(seed, n_workers=GRAY_CHAOS_WORKERS, kinds=GRAY_CHAOS_KINDS)


def _enable_health(plane: Any, **over: Any) -> None:
    r = httpx.put(f"{plane.url}/api/v1/admin/health", json={**GRAY_HEALTH, **over})
    assert r.status_code == 200, r.text


def _health_state(plane: Any, wid: str) -> Optional[str]:
    r = httpx.get(f"{plane.url}/api/v1/admin/health")
    return (r.json()["snapshot"]["workers"].get(wid) or {}).get("state")


def _await_health_state(plane: Any, wid: str, want, timeout_s: float) -> str:
    states = want if isinstance(want, (set, tuple)) else {want}
    deadline = time.time() + timeout_s
    seen = None
    while time.time() < deadline:
        seen = _health_state(plane, wid)      # GET re-evaluates server-side
        if seen in states:
            return seen
        time.sleep(0.05)
    raise AssertionError(f"worker {wid} never reached {states}: {seen}")


@pytest.fixture(scope="module")
def gray_fleet():
    with port_fleet(n=GRAY_CHAOS_WORKERS) as f:
        _enable_health(f.plane)
        yield f


@pytest.mark.slow
@pytest.mark.gray_chaos
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_gray_chaos_seeded(gray_fleet, seed):
    """degrade/jitter/flaky composed with clean kills on 3 port replicas
    with quarantine live: nothing lost, exactly-once SSE, outputs
    byte-identical to a calm replay."""
    plan = _gray_plan(seed)
    assert plan.events == _gray_plan(seed).events      # determinism
    prompts = suite_prompts(seed, 9)
    gray_fleet.run_chaos(plan)
    try:
        records = drive_open_loop(gray_fleet, prompts, seed=seed, max_tokens=7)
    finally:
        gray_fleet.wait_chaos(timeout_s=180.0)
        heal(gray_fleet)
    assert [k for _, k, _ in plan.trace] == [e.kind for e in plan.events]
    await_quiet(gray_fleet)
    assert_no_lost_or_duplicated_jobs(gray_fleet)
    calm_reference(gray_fleet, records, max_tokens=7)
    assert all(m.alive for m in gray_fleet.members)


@pytest.mark.slow
@pytest.mark.gray_chaos
def test_degraded_worker_quarantined_then_readmitted_live():
    """One port replica degrades (alive, heartbeating, 0.3 s a request);
    the plane quarantines it off the shipped latency samples, opens
    probation, and re-admits it once fresh evidence is clean."""
    with port_fleet(n=3, engine_config=FLEET_ENGINE) as fl:
        _enable_health(fl.plane)
        target = fl.members[0]
        urls = [f"http://127.0.0.1:{m.server.port}" for m in fl.members]
        with httpx.Client(timeout=30.0) as c:
            for u in urls:
                c.post(u + "/inference", json={
                    "type": "llm", "params": {"prompt": "warm abcdef", "max_new_tokens": 2}})
        plan = FleetFaultPlan(0, n_workers=3, duration_s=8.0, kinds=GRAY_CHAOS_KINDS)
        plan.events = [FleetEvent(0.0, "degrade", 0, duration_s=6.0, delay_s=0.3)]
        fl.run_chaos(plan)
        try:
            with httpx.Client(timeout=15.0) as c:
                for i in range(8):
                    for u in urls:
                        with contextlib.suppress(httpx.HTTPError):
                            c.post(u + "/inference", json={
                                "type": "llm",
                                "params": {"prompt": f"gray{i} abcdef", "max_new_tokens": 2}})
            got = _await_health_state(fl.plane, target.worker_id,
                                      {SUSPECT, QUARANTINED, PROBATION}, timeout_s=10.0)
            assert got, "degraded worker never flagged"
        finally:
            fl.wait_chaos()
        deadline = time.time() + 10.0
        while time.time() < deadline and 'to="quarantined"' not in \
                metric(fl.plane, "health_transitions_total"):
            httpx.get(f"{fl.plane.url}/api/v1/admin/health")
            time.sleep(0.05)
        trail = metric(fl.plane, "health_transitions_total")
        assert 'from="healthy",to="suspect"' in trail
        assert 'from="suspect",to="quarantined"' in trail
        with httpx.Client(timeout=15.0) as c:
            for i in range(4):
                with contextlib.suppress(httpx.HTTPError):
                    c.post(urls[0] + "/inference", json={
                        "type": "llm", "params": {"prompt": f"calm{i} abcdef",
                                                  "max_new_tokens": 2}})
        assert _await_health_state(fl.plane, target.worker_id, HEALTHY,
                                   timeout_s=20.0) == HEALTHY
        trail = metric(fl.plane, "health_transitions_total")
        assert 'from="quarantined",to="probation"' in trail
        assert 'from="probation",to="healthy"' in trail
        assert target.alive
