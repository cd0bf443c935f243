"""Deadline abandonment in the port's batcher against the JAX batcher.

The JAX and port ``ContinuousBatcher`` over the same stub engine, with the
clock frozen, abandon the same requests — queued, mid-prefill (ragged)
and decoding — with the same typed ``deadline_abandoned`` responses and the
same counters, reactive and predictive (mirrors ``tests/test_gray_chaos.py``
and ``tests/test_predictive.py``). Then on a real engine (``llama3-tiny``,
CPU): a request that cannot meet its deadline is abandoned while its
neighbours finish in full, its blocks come back, the worker engine raises
the typed error, and the knobs ride the worker's serving config."""

import asyncio
import contextlib
import time
from typing import Any, List

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.runtime import batcher as tbatcher  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.base import ServingError  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import (  # noqa: E402
    SERVING_REMOTE_KEYS,
    TorchLLMEngine,
)
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import batcher as jbatcher  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

NOW = 1_000_000.0


class _Slot:
    def __init__(self, ds, request, generated):
        self.request, self.generated = request, list(generated)
        self.finish_reason = None
        self.prefilling = False
        self.prompt_len = len(request.prompt_token_ids)
        self.ds = ds


class _Adm:
    def __init__(self, slot):
        self.slot, self.done, self.off = slot, False, 0


class StubEngine:
    """The engine surface the deadline scan touches: slots it can abort
    and finish, admissions it can abort."""

    supports_ragged = False

    def __init__(self, ds):
        self.ds = ds
        self.slots: List[Any] = [None] * 4
        self.aborted: List[int] = []
        self.finished: List[int] = []

    def request_fits_pool(self, request):
        return True

    def abort_chunked(self, adm):
        self.aborted.append(adm.slot)

    def finish_slot(self, slot, cache=True):
        s = self.slots[slot]
        self.slots[slot] = None
        self.finished.append(slot)
        return self.ds.InferenceResponse(
            request_id=s.request.request_id, token_ids=list(s.generated),
            finish_reason=s.finish_reason, prompt_tokens=s.prompt_len,
            completion_tokens=len(s.generated))


def _req(ds, rid, deadline_s, arrival_ago, max_new=64, prompt=(1, 2, 3)):
    return ds.InferenceRequest(
        request_id=rid, prompt_token_ids=list(prompt),
        sampling=ds.SamplingParams(max_new_tokens=max_new),
        arrival_time=NOW - arrival_ago, deadline_s=deadline_s)


# request id → (deadline_s, arrival_ago, max_new): queued, mid-prefill and
# decoding work, hopeless and not, deadline-less and predictive-only
QUEUED = {"q-late": (5.0, 30.0, 64), "q-fine": (60.0, 0.0, 3),
          "q-none": (None, 999.0, 500), "q-doomed": (60.0, 0.0, 500),
          "q-close": (0.0, 0.1, 1)}
RAGGED = {"r-late": (1.0, 10.0, 40), "r-fine": (100.0, 0.0, 8)}
DECODING = {"d-late": (2.0, 20.0, 50, 10), "d-done": (2.0, 20.0, 5, 5),
            "d-doomed": (30.0, 0.0, 400, 3), "d-none": (None, 50.0, 80, 2)}


def _run_scan(mod, ds, cfg_kw, ema_ms):
    """One deadline scan of an unstarted batcher holding QUEUED in its heap,
    RAGGED as in-flight admissions and DECODING in engine slots → (each
    request's outcome, stats, engine aborts/finishes)."""

    async def body():
        eng = StubEngine(ds)
        b = mod.ContinuousBatcher(eng, mod.BatcherConfig(**cfg_kw))
        b.stats["step_latency_ema_ms"] = ema_ms
        loop = asyncio.get_running_loop()
        futs = {}
        for rid, (dl, ago, n) in QUEUED.items():
            futs[rid] = asyncio.ensure_future(b.submit(_req(ds, rid, dl, ago, n)))
        await asyncio.sleep(0.01)                      # enqueued; loop not started
        for i, (rid, (dl, ago, n)) in enumerate(RAGGED.items()):
            fut = loop.create_future()
            futs[rid] = fut
            b._ragged.append((_Adm(i), mod._QueueItem(
                sort_key=(0, 0.0, 0.0, i), request=_req(ds, rid, dl, ago, n), future=fut)))
        for i, (rid, (dl, ago, n, done)) in enumerate(DECODING.items()):
            slot = i
            req = _req(ds, rid, dl, ago, n)
            eng.slots[slot] = _Slot(ds, req, list(range(done)))
            fut = loop.create_future()
            futs[rid] = fut
            b._slot_items[slot] = mod._QueueItem(
                sort_key=(0, 0.0, 0.0, 10 + i), request=req, future=fut)
        await b._scan_deadlines()
        out = {}
        for rid, fut in futs.items():
            if fut.done():
                r = fut.result()
                out[rid] = (r.error_code, r.finish_reason, r.error, list(r.token_ids),
                            r.prompt_tokens, r.completion_tokens)
            else:
                out[rid] = "pending"
                fut.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await fut
        stats = {k: b.stats[k] for k in ("abandoned", "abandoned_predictive", "completed")}
        return out, stats, sorted(eng.aborted), sorted(eng.finished), len(b._heap)

    return asyncio.run(body())


@pytest.mark.parametrize("cfg_kw,ema_ms", [
    (dict(abandon_deadlines=True), 200.0),
    (dict(abandon_deadlines=True, deadline_grace_s=5.0), 200.0),
    (dict(abandon_deadlines=True, predictive_abandon=True), 1000.0),
    (dict(abandon_deadlines=True, predictive_abandon=True, deadline_grace_s=0.0), 0.0),
    (dict(abandon_deadlines=False, predictive_abandon=True), 1000.0),
])
def test_both_batchers_abandon_the_same_work(monkeypatch, cfg_kw, ema_ms):
    monkeypatch.setattr(time, "time", lambda: NOW)
    got = _run_scan(tbatcher, tds, cfg_kw, ema_ms)
    want = _run_scan(jbatcher, jds, cfg_kw, ema_ms)
    assert got == want
    out, stats = got[0], got[1]
    abandoned = {rid for rid, o in out.items() if o != "pending"}
    assert stats["abandoned"] == len(abandoned) == stats["completed"]
    assert not {"q-none", "d-none", "d-done", "q-fine"} & abandoned   # never these
    if cfg_kw["abandon_deadlines"]:
        assert {"q-late", "r-late", "d-late"} <= abandoned
        for rid in abandoned:
            code, finish, err = out[rid][:3]
            assert (code, finish) == ("deadline_abandoned", "abort") and "grace" in err
        assert out["d-late"][3] == list(range(10))     # decoded tokens kept
        # 500 tokens at 1 s each overrun a deadline 60 s out: predictive only
        assert ("q-doomed" in abandoned) == (
            cfg_kw.get("predictive_abandon", False) and ema_ms >= 1000.0)
    else:
        assert abandoned == set() and got[2] == [] and got[3] == []


def test_projection_math_matches(monkeypatch):
    grid = []
    for pred in (False, True):
        for ema in (0.0, 100.0, 1000.0):
            for dl, ago in ((5.0, 10.0), (0.0, 0.1), (60.0, 0.0), (None, 9999.0)):
                for left in (0, 1, 50, 100, 10_000):
                    grid.append((pred, ema, dl, ago, left))
    outs = []
    for mod, ds in ((tbatcher, tds), (jbatcher, jds)):
        eng = StubEngine(ds)
        b = mod.ContinuousBatcher(eng, mod.BatcherConfig(
            abandon_deadlines=True, deadline_grace_s=0.5))
        res = []
        for pred, ema, dl, ago, left in grid:
            b.cfg.predictive_abandon = pred
            b.stats["step_latency_ema_ms"] = ema
            res.append(b._deadline_hopeless(_req(ds, "x", dl, ago), left, NOW))
        outs.append(res)
    assert outs[0] == outs[1] and any(outs[0]) and not all(outs[0])


def test_abandonment_knobs_are_live_pushable_and_ride_the_serving_config():
    b = tbatcher.ContinuousBatcher(StubEngine(tds), tbatcher.BatcherConfig())
    assert b.cfg.abandon_deadlines is False and b.cfg.deadline_grace_s == 0.5
    b.reconfigure(abandon_deadlines="true", deadline_grace_s="0.25",
                  predictive_abandon="on")
    assert (b.cfg.abandon_deadlines, b.cfg.deadline_grace_s,
            b.cfg.predictive_abandon) == (True, 0.25, True)
    b.reconfigure(abandon_deadlines="off")
    assert b.cfg.abandon_deadlines is False
    for key in ("abandon_deadlines", "deadline_grace_s", "predictive_abandon"):
        assert SERVING_REMOTE_KEYS[key] == key and hasattr(b.cfg, key)


# ---------------------------------------------------------------- a real engine

COMMON = dict(model="llama3-tiny", dtype="float32", device="cpu", max_batch_size=4,
              max_seq_len=256, prefill_buckets=[16, 32, 64], prefix_summary_top_n=0)


@pytest.fixture(scope="module")
def worker():
    jparams = jllama.init_params(get_model_config("llama3-tiny"), jax.random.PRNGKey(4),
                                 jnp.float32)
    w = TorchLLMEngine(dict(COMMON, params=params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"),
        serving={"abandon_deadlines": True, "deadline_grace_s": 0.0,
                 "max_horizon": 4}))
    w.load_model()
    yield w
    w.unload()


def _hold(eng, pace):
    """Pace the engine's decode rounds so a deadline can pass mid-run."""
    real = eng.decode_multi

    def paced(*a, **kw):
        time.sleep(pace)
        return real(*a, **kw)

    eng.decode_multi = paced
    return real


def test_one_hopeless_request_is_abandoned_the_rest_finish(worker):
    eng = worker.engine
    free0 = eng.manager.num_reclaimable
    real = _hold(eng, 0.01)
    try:
        prompts = [f"request number {i} " * 3 for i in range(4)]
        reqs = [worker._build_request(p, worker_cfg(n=24)) for p in prompts]
        reqs[2].deadline_s = 0.05             # 200 tokens cannot land in 50 ms
        reqs[2].sampling.max_new_tokens = 200
        futs = [worker.serving.submit_async(r) for r in reqs]
        resps = [f.result(timeout=120) for f in futs]
    finally:
        eng.decode_multi = real
    for i, r in enumerate(resps):
        if i == 2:
            assert (r.error_code, r.finish_reason) == ("deadline_abandoned", "abort")
            assert r.completion_tokens < 200
        else:
            assert r.error is None and r.completion_tokens == 24
            assert all(0 <= t < eng.model_cfg.vocab_size for t in r.token_ids)
    st = worker.serving.get_stats()
    assert st["abandoned"] == 1 and st["abandoned_predictive"] == 0
    assert eng.num_active == 0 and eng.manager.num_reclaimable == free0


def worker_cfg(n):
    from distributed_gpu_inference_torch.worker.engines.base import GenerationConfig

    return GenerationConfig.from_params({"max_new_tokens": n, "ignore_eos": True})


def test_worker_engine_raises_the_typed_error(worker):
    real = _hold(worker.engine, 0.01)
    try:
        with pytest.raises(ServingError) as err:
            worker.inference({"prompt": "too late", "max_new_tokens": 200,
                              "ignore_eos": True, "deadline_s": 0.02})
    finally:
        worker.engine.decode_multi = real
    assert err.value.error_code == "deadline_abandoned"
    # a request without a deadline is never abandoned
    out = worker.inference({"prompt": "no rush", "max_new_tokens": 8, "ignore_eos": True})
    assert out["usage"]["completion_tokens"] == 8
