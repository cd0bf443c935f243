"""The port's worker process against the REAL control plane of the JAX
package (``testing/harness.py`` ``LiveControlPlane``, aiohttp on loopback),
beside the JAX worker, both with ``llama3-tiny`` (f32, CPU) on the same
weights through each package's ``register_engine`` hook:

- the same queued jobs complete with identical results (token ids, text,
  usage, finish_reason) and both workers' heartbeats carry the same
  ``engine_stats`` keys and the same radix prefix summary;
- a drained job migrates from a port worker to a JAX worker and from a JAX
  worker to a port worker, and the resumed result equals the checkpoint
  over its tokens and an uninterrupted run over all of them;
- a plane ``stale_job`` fences the zombie's completion, and a 401 is
  healed by a token refresh or, when that fails, a re-registration;
- signed requests pass a plane that requires signatures;
- with a host spill tier whose reads fail (a fault plan) and traced jobs,
  the plane ingests the port worker's ``kv_spill`` and ``flight``
  heartbeat blocks as it ingests the JAX worker's, and the worker-side
  timelines carry the same events in the same order."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.testing import faults as tfaults  # noqa: E402
from distributed_gpu_inference_torch.utils import config as tconfig  # noqa: E402
from distributed_gpu_inference_torch.utils.data_structures import TpuTopology  # noqa: E402
from distributed_gpu_inference_torch.worker import api_client as tapi  # noqa: E402
from distributed_gpu_inference_torch.worker import engines as tengines  # noqa: E402
from distributed_gpu_inference_torch.worker import main as tmain  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.testing import faults as jfaults  # noqa: E402
from distributed_gpu_inference_tpu.testing.harness import LiveControlPlane  # noqa: E402
from distributed_gpu_inference_tpu.utils import config as jconfig  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402
from distributed_gpu_inference_tpu.worker import api_client as japi  # noqa: E402
from distributed_gpu_inference_tpu.worker import engines as jengines  # noqa: E402
from distributed_gpu_inference_tpu.worker import main as jmain  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import llm as jllm  # noqa: E402

MODEL = "llama3-tiny"
# one token a decode round (horizon 1), so that a paced round paces tokens;
# a host spill tier (the pool never evicts in these tests, but admissions
# probe the tier, which a fault plan can fail)
GEOM = dict(max_batch_size=4, max_seq_len=256, prefill_buckets=[16, 32, 64, 128],
            checkpoint_interval_tokens=4, serving={"max_horizon": 1},
            kv_spill_host_blocks=64)
TIMEOUT = 120.0
JOBS = [
    {"prompt": "the plane routes jobs to workers " * 3, "max_new_tokens": 12,
     "ignore_eos": True},
    {"prompt": "the plane routes jobs to workers " * 3 + "and back", "max_new_tokens": 9,
     "ignore_eos": True},
    {"messages": [{"role": "system", "content": "a system prompt shared " * 4},
                  {"role": "user", "content": "hello"}], "max_new_tokens": 10,
     "ignore_eos": True},
    {"prompt": "sampled with a seed", "max_new_tokens": 8, "temperature": 0.9,
     "top_k": 20, "seed": 11, "ignore_eos": True},
]


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(5),
                                 jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


class _Paced:
    """Each engine round sleeps ``pace`` seconds first, so a drain or a
    requeue lands while a job is still generating; every batcher response
    is recorded into ``ids`` (the list of the worker being started)."""

    pace = 0.0
    ids: list = []

    @classmethod
    def wrap(cls, llm):
        for name in ("ragged_round", "decode_multi"):
            real = getattr(llm.engine, name)

            def paced(*a, _real=real, **kw):
                time.sleep(cls.pace)
                return _real(*a, **kw)

            setattr(llm.engine, name, paced)
        real_submit, ids = llm.serving.submit, cls.ids

        def submit(req, *a, **kw):
            resp = real_submit(req, *a, **kw)
            ids.append(list(resp.token_ids))
            return resp

        llm.serving.submit = submit


@pytest.fixture(scope="module")
def engines(weights):
    """Both packages' ``llm`` task type → the tiny model on the same
    weights, f32, CPU."""

    def f32_engine(name, eng_cfg, **kw):
        eng_cfg.dtype = "float32"
        return jengine.TPUEngine(name, eng_cfg, params=weights[0])

    class JaxLLM(jllm.TPULLMEngine):
        def load_model(self):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jllm, "TPUEngine", f32_engine)
                super().load_model()
            _Paced.wrap(self)

    def port_llm(config):
        llm = TorchLLMEngine(dict(config, **GEOM, model=MODEL, dtype="float32", device="cpu",
                                  params=params_from_numpy(weights[1], "cpu")))
        real = llm.load_model

        def load():
            real()
            _Paced.wrap(llm)

        llm.load_model = load
        return llm

    jengines.register_engine("llm", lambda config: JaxLLM(dict(config, **GEOM, model=MODEL)))
    tengines.register_engine("llm", port_llm)
    yield
    jengines._OVERRIDES.pop("llm", None)
    tengines._OVERRIDES.pop("llm", None)


@pytest.fixture(autouse=True)
def fingerprints(monkeypatch):
    # one machine per worker object: each registers its own plane row
    class FP:
        n = 0

        def __init__(self):
            FP.n += 1
            self.fp = f"test-fp-{FP.n}-{time.monotonic_ns()}"

        def get_or_create(self):
            return self.fp

    monkeypatch.setattr(tmain, "MachineFingerprint", FP)
    monkeypatch.setattr(jmain, "MachineFingerprint", FP)
    _Paced.pace = 0.0


PACKAGES = {
    "port": (tconfig, tapi, tmain, TpuTopology),
    "jax": (jconfig, japi, jmain, jds.TpuTopology),
}


class Running:
    """One worker of either package on its own thread, its heartbeats and
    its engine's responses recorded."""

    def __init__(self, kind, cp, poll_interval_s=0.02):
        config, api, main, topo = PACKAGES[kind]
        cfg = config.WorkerConfig(name=kind, poll_interval_s=poll_interval_s,
                                  heartbeat_interval_s=0.2)
        self.kind = kind
        self.worker = main.Worker(cfg, api=api.APIClient(cp.url, backoff_s=0.0),
                                  topology=topo(chip_type="cpu"))
        self.beats, self.ids = [], []
        real_hb = self.worker.api.heartbeat

        def heartbeat(**kw):
            resp = real_hb(**kw)
            self.beats.append((kw, resp))
            return resp

        self.worker.api.heartbeat = heartbeat
        _Paced.ids = self.ids
        self.thread = threading.Thread(
            target=lambda: self.worker.start(install_signal_handlers=False), daemon=True)
        self.thread.start()
        assert _wait(lambda: self.worker.state.value == "idle"
                     and "llm" in self.worker.engines), f"{kind} worker did not start"

    @property
    def worker_id(self):
        return self.worker.api.worker_id

    def stop(self):
        self.worker.request_shutdown()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()


def _wait(cond, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _queue(cp, params):
    return cp.call(cp.state.store.create_job({"type": "llm", "params": dict(params)}))


def _finished(cp, jids):
    return all(cp.job(j)["status"] in ("completed", "failed") for j in jids)


def _result(job):
    assert job["status"] == "completed", job
    return {k: v for k, v in job["result"].items() if k != "ttft_ms"}


def test_both_workers_complete_the_same_jobs_with_the_same_results(engines):
    out = {}
    with LiveControlPlane() as cp:
        for kind in ("port", "jax"):
            w = Running(kind, cp)
            try:
                jids = [_queue(cp, p) for p in JOBS]
                assert _wait(lambda: _finished(cp, jids))
                n = len(w.beats)
                assert _wait(lambda: len(w.beats) >= n + 2)   # beats after the last job
                summary = dict(cp.state.prefix_registry._workers[w.worker_id].entries)
                out[kind] = ([_result(cp.job(j)) for j in jids], w, summary)
            finally:
                w.stop()
    (port_res, pw, port_sum), (jax_res, jw, jax_sum) = out["port"], out["jax"]
    assert port_res == jax_res
    assert sorted(pw.ids) == sorted(jw.ids) and len(pw.ids) == len(JOBS)
    assert [r["usage"]["completion_tokens"] for r in port_res] == [12, 9, 10, 8]
    # the same heartbeat channels, and the same radix summary on the plane
    keys = {k: set().union(*(kw.get("engine_stats", {}) for kw, _ in w.beats))
            for k, w in (("port", pw), ("jax", jw))}
    assert keys["port"] == keys["jax"]
    assert {"batcher", "prefix_summary", "prefix_summary_live", "preemptions"} <= keys["port"]
    bkeys = {k: set().union(*(kw.get("engine_stats", {}).get("batcher", {})
                              for kw, _ in w.beats)) for k, w in (("port", pw), ("jax", jw))}
    assert bkeys["port"] == bkeys["jax"]
    assert port_sum == jax_sum and len(port_sum) > 0
    # the same wire: a full snapshot on first contact, then deltas
    wires = {k: [kw["engine_stats"]["prefix_summary"] for kw, _ in w.beats
                 if "prefix_summary" in kw.get("engine_stats", {})]
             for k, w in (("port", pw), ("jax", jw))}
    assert all("full" in ws[0] for ws in wires.values())
    shapes = {k: {tuple(sorted(p)) for p in ws} for k, ws in wires.items()}
    assert shapes["port"] == shapes["jax"]
    # every acked summary: the plane answered resync False
    assert all(resp.get("prefix_summary_resync") is False for kw, resp in pw.beats
               if kw.get("engine_stats", {}).get("prefix_summary"))


@pytest.mark.parametrize("first,second", [("port", "jax"), ("jax", "port")])
def test_a_drained_job_resumes_on_the_other_package(engines, first, second):
    params = {"prompt": "drain me across packages", "max_new_tokens": 48,
              "ignore_eos": True}
    with LiveControlPlane() as cp:
        _Paced.pace = 0.05
        a = Running(first, cp)
        try:
            jid = _queue(cp, params)
            assert _wait(lambda: len((cp.job(jid).get("checkpoint") or {})
                                     .get("generated", [])) >= 4)
        finally:
            a.stop()                       # request_shutdown → JobMigrated
        job = cp.job(jid)
        assert job["status"] == "queued" and job["retry_count"] == 0
        ckpt = job["checkpoint"]["generated"]
        assert 4 <= len(ckpt) < 48 and a.worker.stats["jobs_migrated"] == 1
        _Paced.pace = 0.0
        b = Running(second, cp)
        try:
            assert _wait(lambda: cp.job(jid)["status"] == "completed")
            again = _queue(cp, params)     # the same job, never interrupted
            assert _wait(lambda: cp.job(again)["status"] == "completed")
        finally:
            b.stop()
        resumed, undropped = b.ids
        assert resumed[:len(ckpt)] == ckpt
        assert resumed == undropped and len(resumed) == 48
        # the same result, but for the prefix the second run found cached
        res, ref = _result(cp.job(jid)), _result(cp.job(again))
        res["usage"].pop("cached_tokens")
        ref["usage"].pop("cached_tokens")
        assert res == ref


def test_a_stale_claim_is_flagged_and_its_completion_fenced(engines):
    params = {"prompt": "a job the plane takes back", "max_new_tokens": 32,
              "ignore_eos": True}
    with LiveControlPlane() as cp:
        _Paced.pace = 0.05
        w = Running("port", cp)
        try:
            jid = _queue(cp, params)
            assert _wait(lambda: jid in w.worker._active_jobs)   # generating
            w.worker.config.load_control.acceptance_rate = 0.0   # claim nothing more
            # a sweep requeues it while the worker still generates
            assert cp.call(cp.state.store.try_transition_job(
                jid, "running", owned_by=w.worker_id, status="queued",
                worker_id=None, started_at=None))
            assert _wait(lambda: w.worker.stats.get("stale_claims", 0) >= 1)
            assert _wait(lambda: not w.worker._active_jobs)
            assert cp.job(jid)["status"] == "queued"          # zombie result fenced
            assert w.worker.stats["jobs_completed"] == 0
            _Paced.pace = 0.0
            w.worker.config.load_control.acceptance_rate = 1.0
            assert _wait(lambda: w.worker.stats["jobs_completed"] == 1)
            assert cp.job(jid)["status"] == "completed"
            assert cp.job(jid)["assignment_epoch"] >= 2          # claimed anew
        finally:
            w.stop()


@pytest.mark.parametrize("broken", ["token", "token+refresh"])
def test_a_401_is_healed_by_refresh_or_reregistration(engines, broken):
    with LiveControlPlane() as cp:
        # polls slower than it beats: a poll's 401 is not healed (a JAX
        # worker's neither), and enough of them lock the worker out
        w = Running("port", cp, poll_interval_s=1.0)
        try:
            wid, token = w.worker_id, w.worker.api.auth_token
            fields = {"auth_token_hash": "x" * 64}
            if broken == "token+refresh":
                fields["refresh_token_hash"] = "y" * 64
            cp.call(cp.state.store.update_worker(wid, **fields))
            n = len(w.beats)
            assert _wait(lambda: len(w.beats) >= n + 2)    # two good beats after
            assert w.worker.api.auth_token != token
            assert w.worker_id == wid                      # the same plane row
            jid = _queue(cp, JOBS[0])
            assert _wait(lambda: cp.job(jid)["status"] == "completed")
        finally:
            w.stop()


def test_signed_requests_pass_a_plane_that_requires_them(engines):
    with LiveControlPlane(require_signing=True) as cp:
        w = Running("port", cp)
        try:
            jid = _queue(cp, JOBS[1])
            assert _wait(lambda: cp.job(jid)["status"] == "completed")
            assert w.worker.stats["heartbeats"] >= 1
            forged = tapi.APIClient(cp.url, worker_id=w.worker_id,
                                    auth_token=w.worker.api.auth_token,
                                    signing_secret="not-the-issued-one")
            with pytest.raises(tapi.APIError) as ei:
                forged.fetch_remote_config()
            assert ei.value.status == 401
        finally:
            w.stop()


def test_the_plane_ingests_both_workers_spill_and_flight_blocks(engines):
    seen = {}
    with LiveControlPlane() as cp:
        for kind, faults in (("port", tfaults), ("jax", jfaults)):
            rule = faults.FaultRule("io.spill.host.get", "error")
            with faults.active(faults.FaultPlan(seed=2, rules=[rule])):
                w = Running(kind, cp)
                try:
                    tid = f"trace-{kind}"
                    jid = _queue(cp, dict(JOBS[0], trace_id=tid))
                    assert _wait(lambda: cp.job(jid)["status"] == "completed")

                    def both_blocks():
                        es = [kw.get("engine_stats", {}) for kw, _ in w.beats]
                        return any("flight" in e and "kv_spill" in e for e in es)

                    assert _wait(both_blocks)
                    n = len(w.beats)
                    assert _wait(lambda: len(w.beats) >= n + 1)
                finally:
                    w.stop()
            es = [kw["engine_stats"] for kw, _ in w.beats if "flight" in
                  kw.get("engine_stats", {})]
            tl = cp.state.flight.timeline(tid)
            worker_events = [e["event"] for e in tl["events"] if e["source"] == w.worker_id]
            seen[kind] = (es[-1]["kv_spill"], sorted(es[-1]["flight"]),
                          es[-1]["flight"]["recent"][-1]["trace_id"] == tid, worker_events,
                          cp.state.metrics._kvspill_prev[w.worker_id],
                          cp.state.metrics._flight_prev[w.worker_id],
                          sorted(cp.job(jid)["timeline"]["phases"]))
    assert seen["port"] == seen["jax"]
    kv_spill, keys, trace, events, spill_prev, flight_prev, phases = seen["port"]
    assert kv_spill["host_get_errors"] >= 1 and "breaker_host_state" in kv_spill
    assert keys == ["events_dropped", "recent", "timelines"] and trace
    assert spill_prev["host_get_errors"] == kv_spill["host_get_errors"]
    assert flight_prev["timelines"] == 1
    assert events[:4] == ["worker.picked_up", "worker.start", "batcher.enqueued",
                          "batcher.admitted"]
    assert events[-3:] == ["batcher.first_token", "batcher.completed", "worker.done"] \
        or events[-2:] == ["batcher.completed", "worker.done"]
    assert {"queue_wait", "ttft", "e2e"} <= set(phases)
