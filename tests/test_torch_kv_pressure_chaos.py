"""Seeded kv_pressure chaos on the PyTorch port: the worker-side scenarios
of ``tests/test_kv_pressure_chaos.py`` — preempt → spill → resume storms
driven through the port's ``kv.block.alloc`` seam (a port fault plan,
kind ``pressure``) into ``TorchEngine`` (``llama3-tiny``, f32, CPU), and
the engine's preemption counters riding a port ``APIClient`` heartbeat
into the JAX package's ``LiveControlPlane`` ``/metrics``.

The storms are a function of a seed: the plan's RNG decides which block
allocations see an exhausted pool; the engine recovers every one through
preemption + spill-and-resume with ZERO client-visible errors, and the
same seed gives the same fault trace. The same seeds, storm rule and token
budgets as the JAX twins. The plane-only 429 / Retry-After tests have no
worker in them and are not repeated; the fleet's backpressure under a
shrunken port fleet is ``tests/test_torch_fleet_chaos.py``.
"""

import asyncio
from typing import Any, Dict, List, Tuple

import httpx
import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.runtime.batcher import (  # noqa: E402
    BatcherConfig,
    ContinuousBatcher,
)
from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine  # noqa: E402
from distributed_gpu_inference_torch.testing import faults  # noqa: E402
from distributed_gpu_inference_torch.testing.faults import FaultPlan, FaultRule  # noqa: E402
from distributed_gpu_inference_torch.utils.data_structures import (  # noqa: E402
    InferenceRequest,
    SamplingParams,
)
from distributed_gpu_inference_torch.worker.api_client import APIClient  # noqa: E402
from distributed_gpu_inference_tpu.testing.harness import LiveControlPlane  # noqa: E402

pytestmark = [pytest.mark.chaos, pytest.mark.pressure]

N_SEEDS = 25
DET_SEED = 4321

_ENGINE = None


def _engine() -> TorchEngine:
    global _ENGINE
    if _ENGINE is None:
        _ENGINE = TorchEngine(
            "llama3-tiny",
            EngineConfig(max_batch_size=4, max_seq_len=128, prefill_buckets=(16, 32),
                         multi_step=4, num_blocks=24, block_size=16,
                         spill_host_blocks=64, dtype="float32"),
            device="cpu",
        )
    return _ENGINE


def _reset(eng: TorchEngine) -> None:
    """Cold-start the cache / spill state so every seeded replay sees the
    same pool and produces the same trace."""
    assert eng.num_active == 0
    eng._apply_pending()
    eng.manager.clear_cached(spill=False)
    if eng.manager.host_store is not None:
        eng.manager.host_store._store.clear()


def _reqs(seed: int, n: int = 6, max_new: int = 24) -> List[InferenceRequest]:
    return [
        InferenceRequest(
            request_id=f"s{seed}-r{i}",
            prompt_token_ids=[(seed * 7 + i * 13 + j) % 200 + 4 for j in range(16)],
            sampling=SamplingParams(max_new_tokens=max_new),
        )
        for i in range(n)
    ]


def _plan(seed: int) -> FaultPlan:
    return FaultPlan(seed, [
        # a bounded storm: after the first few allocations ~20% of block
        # allocations see an exhausted pool, at most 8 firings
        FaultRule(site="kv.block.alloc", kind="pressure", prob=0.2, after=6, times=8),
    ])


def _trace(plan: FaultPlan) -> List[Tuple[str, str, str]]:
    return list(plan.trace)


def scenario_kv_pressure(seed: int) -> Dict[str, Any]:
    """One seeded storm through the engine's own scheduler (generate):
    injected exhaustion → preempt → spill → resume → every request
    completes, zero client errors."""
    eng = _engine()
    _reset(eng)
    plan = _plan(seed)
    p0 = eng.stats["preemptions"]
    r0 = eng.stats["resumes"]
    with faults.active(plan):
        outs = eng.generate(_reqs(seed), use_multi_step=True, max_preemptions=50)
    for o in outs:
        assert o.error is None, (seed, o.error)
        assert len(o.token_ids) == 24, (seed, len(o.token_ids))
    preempts = eng.stats["preemptions"] - p0
    resumes = eng.stats["resumes"] - r0
    assert resumes == preempts          # nothing stays frozen
    return {"fired": sum(r.fired for r in plan.rules), "preemptions": preempts,
            "trace": _trace(plan)}


def test_kv_pressure_storm_25_seeds():
    outcomes = [scenario_kv_pressure(s) for s in range(N_SEEDS)]
    # the storm bit: faults fired in most seeds and some seeds preempted
    assert sum(1 for o in outcomes if o["fired"]) >= N_SEEDS // 2
    assert any(o["preemptions"] > 0 for o in outcomes)


def test_kv_pressure_same_seed_same_trace():
    first = scenario_kv_pressure(DET_SEED)
    second = scenario_kv_pressure(DET_SEED)
    assert first == second


def test_kv_pressure_batcher_end_to_end():
    """The same storm through the port's ``ContinuousBatcher``: async timing
    makes traces nondeterministic here, so the OUTCOME contract only."""
    eng = _engine()
    for seed in range(4):
        _reset(eng)
        plan = _plan(seed)

        async def drive():
            b = ContinuousBatcher(eng, BatcherConfig(max_wait_ms=2, max_preemptions=50))
            b.start()
            with faults.active(plan):
                outs = await asyncio.gather(
                    *[b.submit(r, timeout_s=60.0) for r in _reqs(seed)])
            stats = b.get_stats()
            await b.stop()
            return outs, stats

        outs, stats = asyncio.run(drive())
        for o in outs:
            assert o.error is None, (seed, o.error)
            assert len(o.token_ids) == 24
        assert stats["completed"] == 6
        assert stats["resumes"] == stats["preemptions"]


def test_preemption_counters_reach_metrics():
    """A port worker's heartbeat carries the engine's preemption counters;
    the plane's /metrics surfaces them per worker, delta-anchored."""
    with LiveControlPlane() as cp:
        a = APIClient(cp.url, worker_id="w-kv", backoff_s=0.0)
        a.register({"name": "wkv", "region": "us-west", "supported_types": ["llm"]})
        a.heartbeat(status="idle", engine_stats={
            "preemptions": 3, "resumes": 2, "kv_pressure_events": 5})
        body = httpx.get(f"{cp.url}/metrics").text
        assert 'kv_preemptions_total{worker="w-kv"} 3.0' in body
        assert 'kv_resumes_total{worker="w-kv"} 2.0' in body
        assert 'kv_pressure_events_total{worker="w-kv"} 5.0' in body
        # cumulative totals re-report: only the delta lands
        a.heartbeat(status="idle", engine_stats={
            "preemptions": 7, "resumes": 7, "kv_pressure_events": 6})
        body = httpx.get(f"{cp.url}/metrics").text
        assert 'kv_preemptions_total{worker="w-kv"} 7.0' in body
        assert 'kv_resumes_total{worker="w-kv"} 7.0' in body
        a.close()


def test_storm_counters_flow_to_metrics_end_to_end():
    """A real storm's port-engine counters ride a port heartbeat through
    the loopback plane into /metrics."""
    out = scenario_kv_pressure(DET_SEED)
    eng = _engine()
    with LiveControlPlane() as cp:
        a = APIClient(cp.url, worker_id="w-storm", backoff_s=0.0)
        a.register({"name": "ws", "region": "us-west", "supported_types": ["llm"]})
        a.heartbeat(status="idle", engine_stats={
            k: eng.stats[k] for k in ("preemptions", "resumes", "kv_pressure_events")})
        body = httpx.get(f"{cp.url}/metrics").text
        assert f'kv_preemptions_total{{worker="w-storm"}} ' \
               f'{float(eng.stats["preemptions"])}' in body
        a.close()
    assert out["preemptions"] >= 0
