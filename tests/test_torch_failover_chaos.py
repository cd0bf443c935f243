"""Crash-safe generation on port workers: the worker scenarios of
``tests/test_worker_failover_chaos.py`` with the PyTorch port's
``TorchLLMEngine`` (``llama3-tiny``, f32, CPU), ``DirectServer`` and
``APIClient`` behind the JAX package's ``LiveControlPlane``, and the JAX
SDK's ``InferenceClient`` as the client.

A client streams from worker A; A checkpoints the generation to the plane
(admission + per-token cadence); a seeded port fault plan cuts A's socket
after k delivered events (1 ≤ k < n); the SDK reconnects with its offset,
worker B adopts the checkpoint (the epoch fence zombifies A), resumes and
splices — and the client gets the BYTE-IDENTICAL greedy token sequence an
unkilled run produces, across the same 25 seeds. Also: a completed
stream's checkpoint stays adoptable until the plane's age sweep, a queued
job resumes byte-identically from a checkpoint, a drain freezes a queued
job into a checkpoint another worker resumes, and a resume whose client
consumed a holdback flush re-delivers nothing.

The plane-only fencing and SDK-transport tests of the JAX file have no
worker in them and are not repeated; ``tests/test_torch_failover.py``
holds the checkpoints crossing between the two packages' engines.
"""

import time
from typing import Any, Dict, List, Optional

import pytest

pytest.importorskip("torch")

from distributed_gpu_inference_torch.runtime.engine import PreemptedSequence  # noqa: E402
from distributed_gpu_inference_torch.testing import faults  # noqa: E402
from distributed_gpu_inference_torch.testing.faults import FaultPlan, FaultRule  # noqa: E402
from distributed_gpu_inference_torch.utils.data_structures import WorkerState  # noqa: E402
from distributed_gpu_inference_torch.worker.api_client import APIClient, APIError  # noqa: E402
from distributed_gpu_inference_torch.worker.direct_server import DirectServer  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.base import (  # noqa: E402
    GenerationConfig,
    JobMigrated,
)
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.sdk.client import InferenceClient  # noqa: E402
from distributed_gpu_inference_tpu.testing.harness import LiveControlPlane  # noqa: E402

pytestmark = [pytest.mark.chaos, pytest.mark.failover]

N_SEEDS = 25


class _DirectWorker:
    """Minimal worker around a port ``TorchLLMEngine`` + ``DirectServer``:
    the claim state machine, the checkpoint sink (stream cadence → plane)
    and stream adoption — the surfaces the port's ``Worker`` wires."""

    def __init__(self, eng: Any, api: APIClient) -> None:
        self.engines = {"llm": eng}
        self.api = api
        self.state = WorkerState.IDLE
        self.adoptions = 0
        eng.checkpoint_sink = self.push_stream_checkpoint

    def try_begin_job(self) -> bool:
        if self.state != WorkerState.IDLE:
            return False
        self.state = WorkerState.BUSY
        return True

    def end_job(self) -> None:
        if self.state == WorkerState.BUSY:
            self.state = WorkerState.IDLE

    def should_accept_job(self, job: Dict[str, Any]) -> bool:
        return True

    def note_job_done(self, started: float) -> None:
        pass

    def get_status(self) -> Dict[str, Any]:
        return {"state": self.state.value}

    def adopt_stream_checkpoint(self, stream_id: str) -> Optional[Dict[str, Any]]:
        try:
            out = self.api.adopt_stream(stream_id)
        except APIError as exc:
            if exc.status == 404:
                return None
            raise
        self.adoptions += 1
        return out

    def push_stream_checkpoint(self, entry: Dict[str, Any]) -> None:
        if entry.get("kind") != "stream":
            return
        self.api.checkpoint_stream(entry["key"], int(entry.get("epoch") or 0),
                                   entry.get("state"), done=bool(entry.get("done")))


class _Fleet:
    """One live control plane + two port direct workers (A first in
    discovery order) on identically seeded engines; built once per module."""

    def __init__(self) -> None:
        self.plane = LiveControlPlane()
        self.plane.__enter__()
        self.workers: List[_DirectWorker] = []
        self.servers: List[DirectServer] = []
        for name in ("wka", "wkb"):
            eng = TorchLLMEngine({
                "model": "llama3-tiny", "max_batch_size": 2, "max_seq_len": 128,
                "multi_step": 4, "device": "cpu", "dtype": "float32",
                # per-token cadence: a checkpoint exists before every cut
                "checkpoint_interval_tokens": 1,
            })
            eng.load_model()
            api = APIClient(self.plane.url, backoff_s=0.0)
            w = _DirectWorker(eng, api)
            ds = DirectServer(w, host="127.0.0.1", port=0)
            ds.start()
            api.register({
                "name": name, "region": "us-west", "supported_types": ["llm"],
                "supports_direct": True, "direct_url": f"http://127.0.0.1:{ds.port}",
            })
            self.workers.append(w)
            self.servers.append(ds)

    def close(self) -> None:
        for ds in self.servers:
            ds.stop()
        for w in self.workers:
            w.engines["llm"].unload()
            w.api.close()
        self.plane.__exit__(None, None, None)


@pytest.fixture(scope="module")
def fleet():
    f = _Fleet()
    yield f
    f.close()


def _collect(chunks: List[Dict[str, Any]]) -> Dict[str, Any]:
    toks: List[int] = []
    text = ""
    for c in chunks:
        if c.get("done"):
            return {"tokens": toks, "text": text, "finish": c.get("finish_reason"),
                    "usage": c.get("usage", {})}
        toks.extend(c.get("token_ids") or [])
        text += c.get("text_delta") or ""
    raise AssertionError("stream ended without a done event")


def _scenario_prompt(seed: int) -> str:
    return "".join(chr(97 + (seed * 7 + i * 3) % 26) for i in range(12))


def scenario_kill_mid_stream(fleet: _Fleet, seed: int) -> None:
    a, b = fleet.workers
    max_new = 10 + seed % 5
    prompt = _scenario_prompt(seed)
    params = {"prompt": prompt, "max_new_tokens": max_new}
    # the same greedy generation, unkilled, straight off worker B's engine
    ref = _collect(list(b.engines["llm"].stream(dict(params))))
    n = len(ref["tokens"])
    if n < 2:
        params["prompt"] = prompt + "qz"
        ref = _collect(list(b.engines["llm"].stream(dict(params))))
        n = len(ref["tokens"])
    assert n >= 2, f"seed {seed}: reference produced {n} tokens"
    # cut after k delivered events, 1 ≤ k ≤ n-1: before the last token
    kill_after = 1 + (seed % (n - 1))
    plan = FaultPlan(seed, [
        FaultRule(site="worker.direct.stream", kind="drop", after=kill_after, times=1),
    ])
    adoptions_before = b.adoptions
    client = InferenceClient(fleet.plane.url, backoff_s=0.0)
    try:
        with faults.active(plan):
            out = _collect(list(client.stream_chat(timeout_s=60.0, **params)))
    finally:
        client.close()
    assert [t[1] for t in plan.trace] == ["drop"], (seed, plan.trace)
    assert b.adoptions == adoptions_before + 1, seed
    # exactly-once: byte-identical token sequence — no gap, no duplicate
    assert out["tokens"] == ref["tokens"], (seed, kill_after, out["tokens"], ref["tokens"])
    assert out["text"] == ref["text"], (seed, kill_after)
    assert out["finish"] == ref["finish"], (seed, kill_after)
    # both engines quiet, no leaked slot on either side of the failover
    deadline = time.time() + 5.0
    while time.time() < deadline and not (
        a.state == WorkerState.IDLE and b.state == WorkerState.IDLE
        and a.engines["llm"].engine.num_active == 0
        and b.engines["llm"].engine.num_active == 0
    ):
        time.sleep(0.01)
    assert a.engines["llm"].engine.num_active == 0
    assert b.engines["llm"].engine.num_active == 0
    assert a.state == WorkerState.IDLE and b.state == WorkerState.IDLE


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_kill_mid_stream_byte_identical_continuation(fleet, seed):
    scenario_kill_mid_stream(fleet, seed)


def test_completed_stream_checkpoint_stays_until_sweep(fleet):
    """A completed stream's checkpoint stays adoptable (the worker cannot
    know its last bytes arrived); the plane's age sweep retires it."""
    b = fleet.workers[1]
    client = InferenceClient(fleet.plane.url, backoff_s=0.0)
    try:
        chunks = list(client.stream_chat(prompt="hello world", max_new_tokens=6,
                                         timeout_s=60.0))
    finally:
        client.close()
    out = _collect(chunks)
    assert out["finish"] in ("stop", "length")
    sid = next(c["stream_id"] for c in chunks if c.get("stream_id"))
    adopted = b.api.adopt_stream(sid)
    assert adopted["checkpoint"]["v"] == 1
    cp = fleet.plane
    purged = cp.call(cp.state.guarantee.sweep_stale_stream_checkpoints(
        now=time.time() + 31 * 60.0))
    assert sid in purged
    with pytest.raises(APIError) as ei:
        b.api.adopt_stream(sid)
    assert ei.value.status == 404


def test_job_inference_resumes_from_checkpoint_byte_identical(fleet):
    llm = fleet.workers[1].engines["llm"]
    params = {"prompt": "resume me please", "max_new_tokens": 9}
    ref = _collect(list(llm.stream(dict(params))))
    assert len(ref["tokens"]) >= 4, ref
    # the request EXACTLY as the engine builds it (eos merged into stops)
    req = llm._build_request(params["prompt"], GenerationConfig.from_params(params))
    # the first worker died after 3 tokens: the checkpoint carries them
    pre = PreemptedSequence(
        request=req, prompt_len=len(req.prompt_token_ids),
        generated=ref["tokens"][:3], slot_key=(0, 0), start_time=time.time(),
        first_token_time=None, cached_tokens=0,
    )
    resumed = llm.inference({**params, "_failover_ctx": {
        "key": "jf2", "epoch": 2, "checkpoint": pre.to_wire()}})
    assert resumed["text"] == ref["text"]
    assert resumed["usage"]["completion_tokens"] == ref["usage"]["completion_tokens"]
    assert llm.engine.num_active == 0


def test_interrupt_freezes_queued_job_into_checkpoint(fleet):
    llm = fleet.workers[0].engines["llm"]
    llm._interrupt.set()
    try:
        with pytest.raises(JobMigrated) as ei:
            llm.inference({"prompt": "drain mid-generation", "max_new_tokens": 32,
                           "_failover_ctx": {"key": "jd", "epoch": 1, "checkpoint": None}})
    finally:
        llm._interrupt.clear()
    ck = ei.value.checkpoint
    assert ck["v"] == 1
    assert isinstance(ck["generated"], list)
    assert llm.engine.num_active == 0
    # the frozen state resumes cleanly elsewhere (worker B's engine)
    other = fleet.workers[1].engines["llm"]
    resumed = other.inference({"prompt": "drain mid-generation", "max_new_tokens": 32,
                               "_failover_ctx": {"key": "jd2", "epoch": 2,
                                                 "checkpoint": ck}})
    reference = other.inference({"prompt": "drain mid-generation", "max_new_tokens": 32})
    assert resumed["text"] == reference["text"]


def test_sdk_resume_sends_text_offset_and_worker_splices_flush(fleet):
    """Resume after a holdback flush: the consumed TEXT is ahead of what
    the token offset implies; the worker's splice re-delivers nothing."""
    llm = fleet.workers[1].engines["llm"]
    params = {"prompt": "stop string splice", "max_new_tokens": 8,
              "stop": ["ÿÿÿ"]}      # never matches: holdback 2
    ref = _collect(list(llm.stream(dict(params))))
    assert ref["tokens"], ref
    req = llm._build_request(params["prompt"], GenerationConfig.from_params(params))
    pre = PreemptedSequence(
        request=req, prompt_len=len(req.prompt_token_ids), generated=ref["tokens"],
        slot_key=(0, 0), start_time=time.time(), first_token_time=None, cached_tokens=0,
    )
    out = list(llm.stream({**params, "_failover_ctx": {
        "key": "sf", "epoch": 2, "checkpoint": pre.to_wire(),
        "offset": len(ref["tokens"]), "text_offset": len(ref["text"]),
    }}))
    resumed = _collect(out)
    assert resumed["text"] == ""
    assert resumed["tokens"] == []
    assert resumed["finish"] == ref["finish"]
