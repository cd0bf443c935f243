"""SLO-native overload control with port workers: the fleet scenarios of
``tests/test_overload_chaos.py`` on a port ``LiveFleet`` (``TorchLLMEngine``
``llama3-tiny``, f32, CPU) behind the JAX package's ``LiveControlPlane``
with its admission ladder and tier queue fractions, the JAX SDK as the
client and the port's ``BrownoutAutoscaler`` (``server/autoscaler.py``)
driven through the port's ``FleetAutoscaler``.

A 10x free-tier burst with paced paid traffic and one paid stream, under
seeded kill/restart chaos in the heavy suite: paid is never shed, every
accepted job completes exactly once, the stream's offsets are gapless,
every decision reconciles with ``/metrics``, and completed jobs are
byte-identical to a calm, ladder-off replay. The same seeds, counts and
markers as the JAX twins; the ladder, EDF, Retry-After and autoscaler unit
tests there have no worker in them and are not repeated.
"""

import threading
import time
from typing import Any, Dict, List

import httpx
import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.testing.faults import FleetFaultPlan  # noqa: E402
from distributed_gpu_inference_torch.testing.harness import (  # noqa: E402
    FleetAutoscaler,
    FleetWorker,
)
from distributed_gpu_inference_tpu.sdk.client import (  # noqa: E402
    InferenceClient,
    InferenceClientError,
)
from distributed_gpu_inference_torch.server.autoscaler import (  # noqa: E402
    AutoscalerConfig,
    BrownoutAutoscaler,
)
from distributed_gpu_inference_tpu.utils.data_structures import JobStatus  # noqa: E402
from tests.test_torch_fleet_chaos import FLEET_ENGINE, heal, paced, port_fleet  # noqa: E402

N_SEEDS = 25

# the JAX suite's admission geometry: free closes at 5 queued, batch at 3,
# paid holds the full 10, so paid sheds are structurally impossible while
# free is being shed; the degrade rungs sit below the free shed point
SUITE_QUEUE_LIMIT = 10
SUITE_ADMISSION = {
    "enabled": True,
    "rate_tokens_per_s": 0.0,
    "degrade_at": 0.2,
    "no_spec_at": 0.4,
    "clamp_max_tokens": 4,
    "min_retry_after_s": 0.05,
}
SUITE_TIER_FRACTIONS = {"paid": 1.0, "free": 0.5, "batch": 0.3}


@pytest.fixture(scope="module")
def fleet():
    with port_fleet(n=2, submit_queue_limit=SUITE_QUEUE_LIMIT) as f:
        f.plane.state.admission.cfg.update(SUITE_ADMISSION)
        f.plane.state.worker_config._defaults.load_control \
            .tier_queue_fractions = dict(SUITE_TIER_FRACTIONS)
        yield f


def _admission_stats(fl) -> Dict[str, int]:
    return dict(fl.plane.state.admission.stats)


def _metric_value(fl, name: str, **labels: str) -> float:
    text = httpx.get(f"{fl.plane.url}/metrics").text
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        if all(f'{k}="{v}"' in line for k, v in labels.items()):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _create_no_429_retry(c: InferenceClient, params: Dict[str, Any]) -> str:
    """create_job that retries transport blips only and lets 429s surface:
    a shed must be observed, not ridden out."""
    for attempt in range(4):
        try:
            return c.create_job("llm", params)
        except InferenceClientError as exc:
            if exc.status == 599 and attempt < 3:
                time.sleep(0.05)
                continue
            raise


def _free_burst(fl, seed: int, n: int, out: Dict[str, Any]) -> None:
    """n free-tier jobs as fast as the plane answers; 429s never retry."""
    c = InferenceClient(fl.url, backoff_s=0.0, max_retries=0)
    try:
        for i in range(n):
            try:
                jid = _create_no_429_retry(c, {
                    "prompt": f"free s{seed} r{i} aaaa", "max_new_tokens": 8,
                    "tenant": f"burst-{seed % 3}", "tier": "free",
                })
                out["accepted"].append(jid)
            except InferenceClientError as exc:
                assert exc.status == 429, exc
                assert exc.retry_after_s is not None and exc.retry_after_s > 0
                out["shed"] += 1
    finally:
        c.close()


def _paid_traffic(fl, seed: int, n: int, span_s: float, out: Dict[str, Any],
                  errors: List[BaseException]) -> None:
    """Paid jobs spaced across the burst; a single 429 is a violation."""
    c = InferenceClient(fl.url, backoff_s=0.0, max_retries=0)
    try:
        for i in range(n):
            time.sleep(span_s / max(1, n))
            jid = _create_no_429_retry(c, {
                "prompt": f"paid s{seed} r{i} bbbb", "max_new_tokens": 6,
                "tenant": "enterprise", "tier": "paid",
            })
            out["paid_accepted"].append(jid)
    except BaseException as exc:  # noqa: BLE001 — surfaced by the caller
        errors.append(exc)
    finally:
        c.close()


def _paid_stream(fl, seed: int, out: Dict[str, Any],
                 errors: List[BaseException]) -> None:
    """One paid direct stream through the chaos window, exactly-once."""
    c = InferenceClient(fl.url, backoff_s=0.05)
    try:
        chunks = list(c.stream_chat(prompt=f"stream s{seed} cccc", max_new_tokens=6,
                                    timeout_s=90.0, max_stream_resumes=6))
        assert chunks[-1].get("done") is True, chunks[-1:]
        offs = [int(ch["offset"]) for ch in chunks if ch.get("offset") is not None]
        assert offs == sorted(offs), offs
        toks = [t for ch in chunks[:-1] for t in ch.get("token_ids") or []]
        if offs:
            assert len(toks) == offs[-1], (len(toks), offs)
        out["stream_text"] = "".join(ch.get("text_delta") or "" for ch in chunks[:-1])
    except BaseException as exc:  # noqa: BLE001 — surfaced by the caller
        errors.append(exc)
    finally:
        c.close()


def _wait_jobs(fl, job_ids: List[str], timeout_s: float = 120.0) -> Dict[str, Dict[str, Any]]:
    c = InferenceClient(fl.url, backoff_s=0.05)
    done = {}
    try:
        for jid in job_ids:
            job = c.wait_for_job(jid, timeout_s=timeout_s, poll_s=0.05)
            assert job["status"] == "completed", (jid, job)
            done[jid] = job
    finally:
        c.close()
    return done


def _calm_replay_identical(fl, done: Dict[str, Dict[str, Any]]) -> None:
    """Every completed job replayed with the ladder OFF at the same
    effective token budget: greedy text byte for byte."""
    fl.plane.state.admission.cfg.enabled = False
    c = InferenceClient(fl.url, backoff_s=0.05)
    try:
        for jid, job in done.items():
            params = job["params"]
            rid = c.create_job("llm", {"prompt": params["prompt"],
                                       "max_new_tokens": params["max_new_tokens"]})
            calm = c.wait_for_job(rid, timeout_s=90.0, poll_s=0.05)
            assert calm["status"] == "completed", (jid, calm)
            assert calm["result"]["text"] == job["result"]["text"], jid
    finally:
        c.close()
        fl.plane.state.admission.cfg.enabled = True


def _overload_round(fl, seed: int, free_n: int, paid_n: int,
                    chaos: bool) -> Dict[str, Any]:
    """The 10x free burst + paced paid traffic + one paid stream,
    optionally under a seeded kill/restart plan."""
    before = _admission_stats(fl)
    out: Dict[str, Any] = {"accepted": [], "paid_accepted": [], "shed": 0,
                           "stream_text": None}
    errors: List[BaseException] = []
    span = 2.0
    plan = None
    if chaos:
        plan = FleetFaultPlan(seed, n_workers=2, duration_s=span + 1.0, kinds=("kill",))
        fl.run_chaos(plan)
    threads = [
        threading.Thread(target=_paid_traffic, args=(fl, seed, paid_n, span, out, errors),
                         daemon=True),
        threading.Thread(target=_paid_stream, args=(fl, seed, out, errors), daemon=True),
    ]
    for t in threads:
        t.start()
    try:
        _free_burst(fl, seed, free_n, out)
    finally:
        for t in threads:
            t.join(timeout=120.0)
        if plan is not None:
            fl.wait_chaos(timeout_s=180.0)
            heal(fl)
    if errors:
        raise errors[0]
    after = _admission_stats(fl)
    out["delta"] = {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)}
    return out


def _assert_overload_invariants(fl, out: Dict[str, Any], seed: Any) -> None:
    delta = out["delta"]
    assert delta.get("paid:shed", 0) == 0, (seed, delta)
    assert len(out["paid_accepted"]) > 0, seed
    stats = _admission_stats(fl)
    for key, count in stats.items():
        tier, action = key.split(":")
        assert _metric_value(fl, "admission_decisions_total", tenant_tier=tier,
                             action=action) == float(count), (seed, key)
    done = _wait_jobs(fl, out["accepted"] + out["paid_accepted"])
    rows = fl.plane.query("SELECT id, status FROM jobs WHERE status != ?",
                          (JobStatus.COMPLETED.value,))
    assert not rows, (seed, rows)
    clamp = fl.plane.state.admission.cfg.clamp_max_tokens
    for jid, job in done.items():
        if job["params"].get("degraded_max_tokens"):
            assert job["result"]["usage"]["completion_tokens"] <= clamp, (seed, jid)
    _calm_replay_identical(fl, done)


def test_overload_smoke_free_burst_degrades_paid_holds(fleet):
    out = _overload_round(fleet, seed=0, free_n=14, paid_n=3, chaos=False)
    assert out["shed"] >= 1, "free tier never shed under the burst"
    assert out["delta"].get("free:shed", 0) == out["shed"]
    degrades = sum(v for k, v in out["delta"].items()
                   if k.endswith(":degrade_clamp") or k.endswith(":degrade_no_spec"))
    assert degrades >= 1, out["delta"]
    _assert_overload_invariants(fleet, out, seed="smoke")


@pytest.mark.slow
@pytest.mark.overload
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_overload_chaos_seeded(fleet, seed):
    """The burst composed with a seeded kill/restart of a port worker."""
    probe = FleetFaultPlan(seed, n_workers=2, duration_s=3.0, kinds=("kill",))
    assert probe.events == FleetFaultPlan(seed, n_workers=2, duration_s=3.0,
                                          kinds=("kill",)).events
    out = _overload_round(fleet, seed, free_n=16, paid_n=4, chaos=True)
    _assert_overload_invariants(fleet, out, seed)
    assert all(m.alive for m in fleet.members)


@pytest.mark.slow
@pytest.mark.overload
def test_free_tier_sheds_across_suite_seeds(fleet):
    sheds = 0
    for seed in (101, 102, 103):
        out = _overload_round(fleet, seed, free_n=16, paid_n=3, chaos=True)
        sheds += out["shed"]
        assert out["delta"].get("paid:shed", 0) == 0
    assert sheds >= 3


@pytest.mark.slow
@pytest.mark.overload
def test_autoscaler_scales_out_live_fleet_under_chaos():
    """A 2-replica port fleet loses one to a kill under paced traffic; the
    autoscaler adds a cold port replica (timed) and the fleet ends above
    its starting strength with every job completed. The port's tiny model
    answers a 6-token job in tens of milliseconds on the CPU, an order
    under the JAX engine's, so each admission round is paced to a JAX-like
    service time (a job then takes about 0.5 s): unpaced, no job misses
    the 400 ms SLO and the window never degrades."""
    slow = paced(FleetWorker, {"s": 0.45}, rounds=("ragged_round",))
    with port_fleet(n=2, member_factory=lambda i, url, role: slow(i, url, FLEET_ENGINE)) as fl:
        asc = BrownoutAutoscaler(
            AutoscalerConfig(slo_latency_ms=400.0, slo_target=0.9, window_s=3.0,
                             min_samples=4, scale_out_cooldown_s=5.0, max_replicas=3,
                             default_cold_start_s=3.0),
            metrics=fl.plane.state.metrics,
        )
        driver = FleetAutoscaler(
            fl, asc, queue_stats=lambda: fl.plane.call(fl.plane.state.store.queue_stats()),
            tick_s=0.25).start()
        c = InferenceClient(fl.url, backoff_s=0.05)
        try:
            fl.members[1].kill()
            fl.plane.state.metrics.record_chaos_event("kill")
            for i in range(12):
                t0 = time.perf_counter()
                jid = c.create_job("llm", {"prompt": f"asc r{i} dddd", "max_new_tokens": 6})
                job = c.wait_for_job(jid, timeout_s=90.0, poll_s=0.02)
                assert job["status"] == "completed", job
                asc.observe(latency_ms=(time.perf_counter() - t0) * 1000.0)
        finally:
            c.close()
            driver.stop()
            heal(fl)
        assert asc.stats["scale_out"] >= 1, asc.stats
        assert asc.stats["cold_starts_measured"] >= 1
        assert asc.cold_start_s > 0.0
        assert len(fl.members) >= 3
        assert len(fl.alive_members()) >= 2
        text = httpx.get(f"{fl.plane.url}/metrics").text
        assert 'autoscaler_decisions_total{action="scale_out"}' in text
        assert "autoscaler_cold_start_seconds" in text


@pytest.mark.slow
@pytest.mark.overload
def test_fleet_scale_in_retires_youngest():
    with port_fleet(n=1, engine_config=FLEET_ENGINE) as fl:
        assert fl.scale_in() is None
        m = fl.scale_out()
        assert m.alive and len(fl.alive_members()) == 2
        victim = fl.scale_in()
        assert victim is m and not m.alive
        assert len(fl.alive_members()) == 1
