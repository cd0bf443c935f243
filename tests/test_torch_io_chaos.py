"""The durable tier under fire on port workers: the fleet scenarios of
``tests/test_io_chaos.py`` on a spill-tiered port ``LiveFleet``
(``TorchLLMEngine`` ``llama3-tiny``, f32, CPU, an L2 host tier and an
in-process L3 store) behind the JAX package's ``LiveControlPlane``, the JAX
SDK as the client. disk_full / io_error / io_slow / corrupt_read /
torn_write storms composed with clean kills: the worker-side rules are
armed in the port's registry (its spill tiers and file writes), the
plane's store rules in the JAX registry. Nothing lost, exactly-once stream
offsets, outputs byte-identical to a calm replay, and every port breaker
closed again once the storm passes.

All three carry ``slow`` + ``io_chaos`` as their twins do; the spill-wire,
breaker, atomic-write and RESP tests have port twins in
``tests/test_torch_kv_spill.py``, ``tests/test_torch_faults.py`` and
``tests/test_torch_redis_kv.py``.
"""

import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.testing.faults import (  # noqa: E402
    IO_CHAOS_SUITE_KINDS,
    IO_CHAOS_WORKERS,
    FleetEvent,
    FleetFaultPlan,
)
from distributed_gpu_inference_tpu.sdk.client import (  # noqa: E402
    InferenceClient,
    InferenceClientError,
)
from tests.test_torch_fleet_chaos import (  # noqa: E402
    FLEET_ENGINE,
    assert_no_lost_or_duplicated_jobs,
    await_quiet,
    calm_reference,
    heal,
    metric,
    port_fleet,
    suite_prompts,
)

N_SEEDS = 25

IO_FLEET_ENGINE = {**FLEET_ENGINE, "kv_spill_host_blocks": 16, "kv_remote_url": "memory://"}


def _io_plan(seed: int) -> FleetFaultPlan:
    return FleetFaultPlan(seed, n_workers=IO_CHAOS_WORKERS, kinds=IO_CHAOS_SUITE_KINDS)


@pytest.fixture(scope="module")
def io_fleet():
    # short breaker windows so post-storm probes heal within the test: the
    # env is read at engine construction
    old = os.environ.get("DGI_IO_BREAKER_OPEN_S")
    os.environ["DGI_IO_BREAKER_OPEN_S"] = "1.0"
    try:
        with port_fleet(n=IO_CHAOS_WORKERS, engine_config=IO_FLEET_ENGINE) as f:
            yield f
    finally:
        if old is None:
            os.environ.pop("DGI_IO_BREAKER_OPEN_S", None)
        else:
            os.environ["DGI_IO_BREAKER_OPEN_S"] = old


def _create_job_resilient(c: InferenceClient, prompt: str, max_tokens: int,
                          deadline_s: float = 45.0) -> str:
    """Submit through a disk_full window's typed 503s, honoring
    ``retry_after_s`` until the window passes."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return c.create_job("llm", {"prompt": prompt, "max_new_tokens": max_tokens})
        except InferenceClientError as exc:
            if exc.status < 500 or time.monotonic() > deadline:
                raise
            time.sleep(max(exc.retry_after_s or 0.25, 0.25))


def _drive_open_loop_io(fleet, prompts: List[str], seed: int, max_tokens: int,
                        rate: float = 2.5, stream_every: int = 3) -> List[Dict[str, Any]]:
    """The fleet driver with degraded-mode submission: queued jobs retry
    through store-outage 503s, every third request a direct stream."""
    rng = random.Random(seed * 101 + 3)
    arrivals, t = [], 0.0
    for _ in prompts:
        t += rng.expovariate(rate)
        arrivals.append(t)
    results: List[Optional[Dict[str, Any]]] = [None] * len(prompts)
    errors: List[BaseException] = []
    t0 = time.monotonic()

    def queued(i: int, prompt: str) -> None:
        c = InferenceClient(fleet.url, backoff_s=0.05)
        try:
            job_id = _create_job_resilient(c, prompt, max_tokens)
            job = c.wait_for_job(job_id, timeout_s=90.0, poll_s=0.05)
            assert job["status"] == "completed", (prompt, job)
            results[i] = {"prompt": prompt, "path": "queued",
                          "text": job["result"]["text"], "job_id": job_id}
        finally:
            c.close()

    def streamed(i: int, prompt: str) -> None:
        c = InferenceClient(fleet.url, backoff_s=0.05)
        try:
            chunks = list(c.stream_chat(prompt=prompt, max_new_tokens=max_tokens,
                                        timeout_s=90.0, max_stream_resumes=6))
            assert chunks[-1].get("done") is True, (prompt, chunks[-1:])
            text = "".join(ch.get("text_delta") or "" for ch in chunks[:-1])
            offs = [int(ch["offset"]) for ch in chunks if ch.get("offset") is not None]
            assert offs == sorted(offs), (prompt, offs)
            toks = [tk for ch in chunks[:-1] for tk in ch.get("token_ids") or []]
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


def _breaker_states(fleet) -> List[tuple]:
    out = []
    for m in fleet.members:
        eng = getattr(m.llm, "engine", None)
        mgr = getattr(eng, "manager", None) if eng is not None else None
        if mgr is None:
            continue
        for tier, br in mgr.breakers.items():
            out.append((m.tag, tier, br.state))
    return out


def _assert_breakers_reconciled(fleet, timeout_s: float = 25.0) -> None:
    """Every tripped port breaker heals once the storm passes: nudge
    requests force KV churn that lands the half-open probes."""
    c = InferenceClient(fleet.url, backoff_s=0.05)
    try:
        deadline, n = time.time() + timeout_s, 0
        while True:
            bad = [s for s in _breaker_states(fleet) if s[2] != "closed"]
            if not bad:
                return
            assert time.time() < deadline, f"breakers never healed: {bad}"
            job_id = _create_job_resilient(c, f"heal{n} abcdefgh", max_tokens=4)
            c.wait_for_job(job_id, timeout_s=30.0, poll_s=0.05)
            n += 1
            time.sleep(0.2)
    finally:
        c.close()


@pytest.mark.slow
@pytest.mark.io_chaos
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_io_chaos_seeded(io_fleet, seed):
    plan = _io_plan(seed)
    assert plan.events == _io_plan(seed).events        # determinism
    prompts = suite_prompts(seed, 9)
    io_fleet.run_chaos(plan)
    try:
        records = _drive_open_loop_io(io_fleet, prompts, seed=seed, max_tokens=7)
    finally:
        io_fleet.wait_chaos(timeout_s=180.0)
        heal(io_fleet)
    assert [k for _, k, _ in plan.trace] == [e.kind for e in plan.events]
    await_quiet(io_fleet)
    assert_no_lost_or_duplicated_jobs(io_fleet)
    calm_reference(io_fleet, records, max_tokens=7)
    assert all(m.alive for m in io_fleet.members)
    _assert_breakers_reconciled(io_fleet)


@pytest.mark.slow
@pytest.mark.io_chaos
def test_fully_dark_spill_tier_degrades_to_recompute(io_fleet):
    """EVERY spill / checkpoint op fails for the window (io_error at prob
    1.0): serving degrades to recompute with zero failed requests, and the
    port's breakers close again once the tier is back."""
    plan = FleetFaultPlan(0, n_workers=IO_CHAOS_WORKERS, duration_s=8.0,
                          kinds=IO_CHAOS_SUITE_KINDS)
    plan.events = [FleetEvent(0.0, "io_error", -1, duration_s=6.0, prob=1.0)]
    prompts = suite_prompts(777, 8)
    io_fleet.run_chaos(plan)
    try:
        records = _drive_open_loop_io(io_fleet, prompts, seed=777, max_tokens=7)
    finally:
        io_fleet.wait_chaos(timeout_s=60.0)
    await_quiet(io_fleet)
    assert_no_lost_or_duplicated_jobs(io_fleet)
    calm_reference(io_fleet, records, max_tokens=7)
    assert all(m.alive for m in io_fleet.members)
    _assert_breakers_reconciled(io_fleet)


@pytest.mark.slow
@pytest.mark.io_chaos
def test_disk_full_window_bounces_then_recovers(io_fleet):
    """Every durable write fails for the window — the plane's store
    mutations (JAX registry), the port workers' spill puts and file writes
    (port registry) — while reads serve; nothing is lost."""
    plan = FleetFaultPlan(1, n_workers=IO_CHAOS_WORKERS, duration_s=4.0,
                          kinds=IO_CHAOS_SUITE_KINDS)
    plan.events = [FleetEvent(0.2, "disk_full", -1, duration_s=2.0)]
    prompts = suite_prompts(42, 6)
    io_fleet.run_chaos(plan)
    try:
        records = _drive_open_loop_io(io_fleet, prompts, seed=42, max_tokens=6)
    finally:
        io_fleet.wait_chaos(timeout_s=60.0)
    assert len(records) == len(prompts)
    await_quiet(io_fleet)
    assert_no_lost_or_duplicated_jobs(io_fleet)
    assert "store_degraded 0.0" in metric(io_fleet.plane, "store_degraded")
