"""The port's flight recorder against the JAX package's.

- ``runtime/flight.py``: the same wire, merge and phase derivation for the
  same events (a copy, not an import), the no-op timeline, ``DGI_FLIGHT``
  and the per-request cap with its boundary reserve.
- The worker engine: for the same traced request the port's
  ``TorchLLMEngine`` and the JAX ``TPULLMEngine`` (``llama3-tiny``, f32,
  CPU, the same weights) give timelines with the same events in the same
  order — a blocking request, a queued job, a job resumed from a
  checkpoint and a stream — the engine's own ``t_start`` /
  ``t_first_token`` on the response, and the same heartbeat
  ``flight_wire_stats``."""

import asyncio
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.runtime import flight as tflight  # noqa: E402
from distributed_gpu_inference_torch.runtime.engine import PreemptedSequence  # noqa: E402
from distributed_gpu_inference_torch.utils.data_structures import (  # noqa: E402
    InferenceRequest,
    SamplingParams,
)
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import flight as jflight  # noqa: E402

EVENTS = [("worker.picked_up", 10.0), ("batcher.enqueued", 10.5), ("batcher.admitted", 10.75),
          ("batcher.chunk_round", 11.0), ("batcher.first_token", 10.9),
          ("batcher.completed", 12.0), ("worker.done", 12.5)]


def test_wire_merge_and_phases_match():
    outs = []
    for mod in (jflight, tflight):
        tl = mod.Timeline("t-1", source="w1")
        for name, ts in EVENTS:
            tl.note_at(name, ts, slot=1, note=("x" * 300, 1) if name == "worker.done" else None)
        tl.extend_at([("handoff.begin", 11.5), ("bad",), ("handoff.commit", "x"),
                      ("handoff.commit", 11.8)])
        wire = tl.wire(done=True)
        srv = mod.Timeline("t-1", source="server")
        srv.note_at("server.submitted", 9.0)
        srv.note_at("server.claimed", 10.2)
        merged = mod.merge_events({"w1": wire["events"],
                                   "server": srv.wire()["events"]})
        outs.append((wire, merged, mod.phase_durations(merged), mod.PHASES,
                     mod.FLIGHT_EVENT_CAP, sorted(mod.BOUNDARY_EVENTS)))
    assert outs[1] == outs[0]
    done = next(e for e in outs[0][0]["events"] if e[0] == "worker.done")
    assert len(done[2]["note"]) == 128          # a non-scalar attr, cut to a string
    assert set(outs[0][2]) == {"queue_wait", "prefill", "ttft", "handoff", "decode", "e2e"}


def test_null_timeline_env_switch_and_cap(monkeypatch):
    assert tflight.timeline_for({"prompt": "x"}) is tflight.NULL_TIMELINE
    assert tflight.timeline_for("not a dict") is tflight.NULL_TIMELINE
    tflight.NULL_TIMELINE.note("anything")
    assert tflight.NULL_TIMELINE.wire() is None and not tflight.NULL_TIMELINE.enabled
    assert tflight.timeline_for({"trace_id": "t"}).enabled
    monkeypatch.setenv("DGI_FLIGHT", "off")
    assert tflight.timeline_for({"trace_id": "t"}) is tflight.NULL_TIMELINE
    counts = []
    for mod in (jflight, tflight):
        tl = mod.Timeline("t", cap=32)
        for i in range(40):
            tl.note("batcher.chunk_round", off=i)
        tl.note("batcher.completed")
        tl.note("worker.done")
        counts.append((len(tl.events), tl.dropped, [e[0] for e in tl.events[-2:]],
                       tl.wire()["dropped"]))
    assert counts[0] == counts[1]
    assert counts[0][2] == ["batcher.completed", "worker.done"]   # the reserve held


# ---------------------------------------------------------------- the worker engines

MODEL = "llama3-tiny"
COMMON = dict(model=MODEL, max_batch_size=4, max_seq_len=128, prefill_buckets=[16, 32, 64],
              prefix_summary_top_n=0, serving={"max_horizon": 4})
PARAMS = {"prompt": "trace this request through the batcher", "max_new_tokens": 6,
          "ignore_eos": True}


@pytest.fixture(scope="module")
def pair():
    jparams = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(8), jnp.float32)
    from distributed_gpu_inference_tpu.worker.engines import llm as jllm

    def f32_engine(name, eng_cfg, **kw):
        eng_cfg.dtype = "float32"
        return jengine.TPUEngine(name, eng_cfg, params=jparams)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllm, "TPUEngine", f32_engine)
        jw = jllm.TPULLMEngine(dict(COMMON))
        jw.load_model()
    tw = TorchLLMEngine(dict(COMMON, dtype="float32", device="cpu",
                             params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                      "cpu")))
    tw.load_model()
    yield jw, tw
    jw.unload()
    tw.unload()


def _names(wire):
    return [e[0] for e in wire["events"]]


def _ordered(wire):
    ts = [e[1] for e in wire["events"]]
    return ts == sorted(ts)


def test_blocking_request_timelines_match(pair):
    got = []
    for w in pair:
        t0 = time.time()
        out = w.inference(dict(PARAMS, trace_id="t-block", _flight_picked_up_ts=t0))
        wire = out["timeline"]
        assert wire["trace_id"] == "t-block" and wire["done"] is True
        assert wire["events"][0][:2] == ["worker.picked_up", round(t0, 6)]
        got.append((_names(wire), out["usage"], out["text"]))
    assert got[1] == got[0]
    assert got[0][0] == ["worker.picked_up", "worker.start", "batcher.enqueued",
                         "batcher.admitted", "batcher.chunk_round", "batcher.first_token",
                         "batcher.completed", "worker.done"]


def test_untraced_requests_carry_no_timeline(pair):
    for w in pair:
        out = w.inference(dict(PARAMS))
        assert "timeline" not in out


def test_job_and_resumed_job_timelines_match(pair):
    got = []
    for w in pair:
        out = w.inference(dict(PARAMS, trace_id="t-job",
                               _failover_ctx={"key": "job-1", "kind": "job", "epoch": 1}))
        # a complete checkpoint (the same wire for both): served without
        # the engine
        ckpt = PreemptedSequence(
            request=InferenceRequest(prompt_token_ids=[5, 6, 7],
                                     sampling=SamplingParams(max_new_tokens=2)),
            prompt_len=3, generated=[9, 10], slot_key=(0, 0), start_time=1.0,
            first_token_time=2.0, cached_tokens=0).to_wire()
        done = w.inference(dict(PARAMS, trace_id="t-done", _failover_ctx={
            "key": "job-2", "kind": "job", "epoch": 1, "checkpoint": ckpt}))
        got.append((_names(out["timeline"]), _names(done["timeline"]),
                    _ordered(out["timeline"])))
    assert got[1] == got[0]
    assert got[0][0][:2] == ["worker.start", "batcher.enqueued"]
    assert got[0][1] == ["worker.start", "worker.resume_from_checkpoint"]


def test_stream_timelines_match_and_ride_the_final_chunk(pair):
    async def collect(w):
        return [c async for c in w.stream_inference(dict(PARAMS, trace_id="t-stream"))]

    got = []
    for w in pair:
        chunks = asyncio.run(collect(w))
        assert all("timeline" not in c for c in chunks[:-1])
        final = chunks[-1]
        assert final["done"] and final["timeline"]["trace_id"] == "t-stream"
        got.append((_names(final["timeline"]), final["usage"]))
    assert got[1] == got[0]
    assert got[0][0][0] == "worker.stream.start" and got[0][0][-1] == "worker.stream.done"


def test_engine_boundaries_ride_the_response(pair):
    from distributed_gpu_inference_torch.utils import data_structures as tds
    from distributed_gpu_inference_tpu.utils import data_structures as jds

    for w, ds in zip(pair, (jds, tds)):
        req = ds.InferenceRequest(prompt_token_ids=[3, 4, 5, 6],
                                  sampling=ds.SamplingParams(max_new_tokens=3))
        resp = w.serving.submit(req)
        assert set(resp.extra) >= {"t_start", "t_first_token"}
        assert resp.extra["t_start"] == req.arrival_time
        assert resp.extra["t_start"] <= resp.extra["t_first_token"] <= time.time()


def test_heartbeat_flight_stats_match(pair):
    stats = [w.flight_wire_stats() for w in pair]
    assert stats[0] is not None and stats[1] is not None
    assert sorted(stats[0]) == sorted(stats[1]) == ["events_dropped", "recent", "timelines"]
    assert stats[1]["timelines"] == stats[0]["timelines"] >= 3
    assert [r["trace_id"] for r in stats[1]["recent"]] == \
        [r["trace_id"] for r in stats[0]["recent"]]
