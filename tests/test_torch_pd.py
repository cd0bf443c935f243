"""Prefill/decode disaggregation through the JAX package's control plane
(``testing/harness.py`` ``LiveControlPlane``: the jobs API, the PD
scheduler over role-tagged registrations, ``server/pd_flow.py``'s pinned
stage jobs), with workers of either package on ``llama3-tiny`` (f32, CPU,
the same weights): a port prefill worker and a port decode worker, a JAX
prefill worker and a port decode worker, a port prefill worker and a JAX
decode worker. Each PD parent's ``token_ids`` equal the single-engine
oracle exactly, with ``migration_bytes`` > 0; the decode worker serves its
data plane on its ``pd_data_plane_url``; the prefill workers' heartbeat
``pd`` blocks and both packages' ``kv_migrate`` blocks carry the same keys
and the plane ingests the port's. Also: the local-affinity stage pair, and
the push retry ladder under port fault plans."""

import socket
import threading
import time

import httpx
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.comm.data_plane import (  # noqa: E402
    TRANSPORT_ERRORS,
    HTTPStatusError,
)
from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.testing import faults as tfaults  # noqa: E402
from distributed_gpu_inference_torch.utils import config as tconfig  # noqa: E402
from distributed_gpu_inference_torch.utils.data_structures import TpuTopology  # noqa: E402
from distributed_gpu_inference_torch.worker import api_client as tapi  # noqa: E402
from distributed_gpu_inference_torch.worker import engines as tengines  # noqa: E402
from distributed_gpu_inference_torch.worker import main as tmain  # noqa: E402
from distributed_gpu_inference_torch.worker.api_client import Response  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.testing.harness import LiveControlPlane  # noqa: E402
from distributed_gpu_inference_tpu.utils import config as jconfig  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402
from distributed_gpu_inference_tpu.worker import api_client as japi  # noqa: E402
from distributed_gpu_inference_tpu.worker import engines as jengines  # noqa: E402
from distributed_gpu_inference_tpu.worker import main as jmain  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import llm as jllm  # noqa: E402

MODEL = "llama3-tiny"
GEOM = dict(max_batch_size=4, max_seq_len=128, prefill_buckets=[16, 32, 64])
PROMPT = list(range(10, 40))
NEW = 8
TIMEOUT = 120.0
PD_PARAMS = {"pd_disaggregated": True, "prompt_token_ids": PROMPT, "max_tokens": NEW,
             "temperature": 0, "ignore_eos": True}


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(9), jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def oracle(weights):
    eng = jengine.TPUEngine(MODEL, jengine.EngineConfig(
        max_batch_size=2, max_seq_len=128, prefill_buckets=(16, 32, 64), dtype="float32"),
        params=weights[0])
    req = jds.InferenceRequest(prompt_token_ids=list(PROMPT), sampling=jds.SamplingParams(
        max_new_tokens=NEW, ignore_eos=True))
    return list(eng.generate([req])[0].token_ids)


def _port_llm(weights, **over):
    llm = TorchLLMEngine(dict(GEOM, model=MODEL, dtype="float32", device="cpu",
                              params=params_from_numpy(weights[1], "cpu"), **over))
    llm.load_model()
    return llm


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

    jengines.register_engine("llm", lambda config: JaxLLM(dict(config, **GEOM, model=MODEL)))
    tengines.register_engine("llm", lambda config: TorchLLMEngine(dict(
        config, **GEOM, model=MODEL, dtype="float32", device="cpu",
        params=params_from_numpy(weights[1], "cpu"))))
    yield
    jengines._OVERRIDES.pop("llm", None)
    tengines._OVERRIDES.pop("llm", None)


@pytest.fixture(autouse=True)
def fingerprints(monkeypatch):
    class FP:
        n = 0

        def __init__(self):
            FP.n += 1
            self.fp = f"pd-fp-{FP.n}-{time.monotonic_ns()}"

        def get_or_create(self):
            return self.fp

    monkeypatch.setattr(tmain, "MachineFingerprint", FP)
    monkeypatch.setattr(jmain, "MachineFingerprint", FP)


PACKAGES = {
    "port": (tconfig, tapi, tmain, TpuTopology),
    "jax": (jconfig, japi, jmain, jds.TpuTopology),
}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


class Running:
    """One worker of either package on its own thread with a PD role, its
    heartbeats recorded."""

    def __init__(self, kind, cp, role):
        config, api, main, topo = PACKAGES[kind]
        kw = {}
        if role == "decode":
            kw["pd_data_plane_url"] = f"http://127.0.0.1:{_free_port()}"
        cfg = config.WorkerConfig(name=f"{kind}-{role}", poll_interval_s=0.02,
                                  heartbeat_interval_s=0.2, role=role, **kw)
        self.url = kw.get("pd_data_plane_url")
        self.worker = main.Worker(cfg, api=api.APIClient(cp.url, backoff_s=0.0),
                                  topology=topo(chip_type="cpu"))
        self.beats = []
        real_hb = self.worker.api.heartbeat

        def heartbeat(**hb):
            resp = real_hb(**hb)
            self.beats.append(hb)
            return resp

        self.worker.api.heartbeat = heartbeat
        self.thread = threading.Thread(
            target=lambda: self.worker.start(install_signal_handlers=False), daemon=True)
        self.thread.start()
        assert _wait(lambda: self.worker.state.value == "idle"
                     and "llm" in self.worker.engines), f"{kind} {role} worker did not start"

    @property
    def worker_id(self):
        return self.worker.api.worker_id

    @property
    def llm(self):
        return self.worker.engines["llm"]

    def block_keys(self, name):
        return set().union(*(b.get("engine_stats", {}).get(name, {}) for b in self.beats))

    def stop(self):
        self.worker.request_shutdown()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()


def _pd_job(cp, oracle, prefill, decode):
    r = httpx.post(cp.url + "/api/v1/jobs", json={"type": "llm", "params": PD_PARAMS},
                   timeout=30)
    assert r.status_code == 201, r.text
    jid = r.json()["job_id"]
    assert _wait(lambda: cp.job(jid)["status"] in ("completed", "failed"))
    parent = cp.job(jid)
    assert parent["status"] == "completed", parent
    res = parent["result"]
    assert res["pd_disaggregated"] is True
    assert (res["prefill_worker"], res["decode_worker"]) == (prefill.worker_id,
                                                             decode.worker_id)
    assert res["migration_bytes"] > 0 and res["ttft_ms"] is not None
    assert res["token_ids"] == oracle
    return res


def _health(url):
    return httpx.get(url + "/health", timeout=10).json()


def test_pd_jobs_across_both_packages_equal_the_oracle(engines, oracle):
    with LiveControlPlane() as cp:
        decode = Running("port", cp, "decode")
        prefill = Running("jax", cp, "prefill")
        jdecode = None
        try:
            # the role-decode worker serves its data plane on its URL's port
            assert _health(decode.url)["pd_kv_receiver"] is True
            assert httpx.post(decode.url + "/inference/forward", content=b"x",
                              timeout=10).status_code == 404
            _pd_job(cp, oracle, prefill, decode)            # JAX prefill → port decode
            prefill.stop()
            prefill = Running("port", cp, "prefill")
            res = _pd_job(cp, oracle, prefill, decode)       # port → port
            assert prefill.llm.pd_stats["handoffs_committed"] == 1
            assert prefill.llm.pd_stats["handoff_bytes"] == res["migration_bytes"]
            decode.stop()
            jdecode = Running("jax", cp, "decode")
            decode = None
            _pd_job(cp, oracle, prefill, jdecode)            # port prefill → JAX decode
            # the plane's registry carries the roles and the data-plane URL
            # (the heartbeat blocks below: each package's prefill worker)
            assert _wait(lambda: prefill.block_keys("pd") == {"handoffs_committed",
                                                              "handoff_bytes"})
            # a kv_migrate block on both packages: one router hint with no
            # peer URL falls back (counted) on each
            for llm in (prefill.llm, jdecode.llm):
                llm._maybe_migrate_kv({"prompt": "x",
                                       "kv_migrate_from": {"data_plane_url": ""}})
            assert _wait(lambda: prefill.block_keys("kv_migrate")
                         and jdecode.block_keys("kv_migrate"))
            assert prefill.block_keys("kv_migrate") == jdecode.block_keys("kv_migrate") \
                == {"fallback_recompute"}
            metrics = cp.state.metrics
            assert metrics._pd_prev[prefill.worker_id]["handoffs_committed"] == 2
            assert metrics._kvmig_prev[prefill.worker_id]["fallback_recompute"] == 1
        finally:
            for w in (prefill, decode, jdecode):
                if w is not None:
                    w.stop()


def test_jax_prefill_worker_blocks_have_the_port_keys(engines, oracle):
    # the JAX prefill worker's pd block against a port prefill worker's
    with LiveControlPlane() as cp:
        decode = Running("port", cp, "decode")
        try:
            keys = {}
            for kind in ("jax", "port"):
                prefill = Running(kind, cp, "prefill")
                try:
                    _pd_job(cp, oracle, prefill, decode)
                    assert _wait(lambda: prefill.block_keys("pd"))
                    keys[kind] = prefill.block_keys("pd")
                finally:
                    prefill.stop()
            assert keys["port"] == keys["jax"] == {"handoffs_committed", "handoff_bytes"}
        finally:
            decode.stop()


def test_local_affinity_retains_the_slot(weights, oracle):
    llm = _port_llm(weights)
    try:
        out = llm.inference({"pd_stage": "prefill", "prompt_token_ids": PROMPT,
                             "max_tokens": NEW, "temperature": 0, "ignore_eos": True,
                             "kv_cache_key": "aff-1", "target_worker": "w1",
                             "decode_worker": "w1", "decode_url": "http://unused.invalid"})
        assert out["local"] is True and out["migration_bytes"] == 0
        assert out["usage"] == {"prompt_tokens": len(PROMPT), "completion_tokens": 0,
                                "total_tokens": len(PROMPT)}
        assert "aff-1" in llm._pd_slots and llm.pd_stats["handoffs_local"] == 1
        dec = llm.inference({"pd_stage": "decode", "kv_cache_key": "aff-1"})
        assert dec["token_ids"] == oracle and dec["usage"]["prompt_tokens"] == 0
        assert llm.serving.get_stats()["adopted"] == 1 and llm.engine.num_active == 0
        with pytest.raises(RuntimeError, match="handoff never arrived"):
            llm.inference({"pd_stage": "decode", "kv_cache_key": "aff-1"})
        # an adoption never claimed ages out on the heartbeat cadence
        llm.inference({"pd_stage": "prefill", "prompt_token_ids": PROMPT, "max_tokens": NEW,
                       "kv_cache_key": "aff-2"})
        assert llm.engine.num_active == 1
        llm.pd_slot_ttl_s = 0.0
        llm.pd_maintain()
        assert llm.engine.num_active == 0 and llm.pd_stats["adopted_expired"] == 1
        assert llm.pd_wire_stats() == {"handoffs_local": 2, "adopted_expired": 1}
    finally:
        llm.unload()


# -- the push retry ladder (tests/test_pd_chaos.py, with port fault plans)


class _StubClient:
    def __init__(self, status=200):
        self.posts, self.status = 0, status

    def post(self, url, content, headers=None, timeout=None):
        self.posts += 1
        return Response(self.status, b'{"state": "staged"}')


def _shell(**cfg):
    llm = TorchLLMEngine({"model": MODEL, **cfg})
    llm.fault_tag = "pf0"
    return llm


def test_pd_push_rides_out_transport_blips_with_counted_retries():
    llm, client = _shell(pd_push_backoff_s=0.001), _StubClient()
    plan = tfaults.FaultPlan(0, [tfaults.FaultRule(site="worker.pd.push", kind="drop",
                                                   times=2, match={"worker": "pf0"})])
    with tfaults.active(plan):
        r = llm._pd_push(client, "http://d.invalid/kv/transfer", b"TPUS")
    assert r.status_code == 200 and llm.pd_stats["piece_retries"] == 2
    assert client.posts == 1                  # the drops never reached the wire


def test_pd_push_retries_a_5xx_and_gives_up_after_the_budget():
    llm = _shell(pd_push_backoff_s=0.001)
    plan = tfaults.FaultPlan(0, [tfaults.FaultRule(site="worker.pd.push", kind="flap",
                                                   times=None, match={"worker": "pf0"})])
    with tfaults.active(plan):
        with pytest.raises(TRANSPORT_ERRORS):
            llm._pd_push(_StubClient(), "http://d.invalid/kv/transfer", b"TPUS")
    assert llm.pd_stats["piece_retries"] == llm._pd_push_retries == 3
    client = _StubClient(status=503)
    with pytest.raises(RuntimeError, match="HTTP 503"):
        llm._pd_push(client, "http://d.invalid/kv/transfer", b"TPUS")
    assert client.posts == 4


def test_pd_push_does_not_retry_receiver_4xx():
    llm, client = _shell(), _StubClient(status=404)
    with pytest.raises(HTTPStatusError):
        llm._pd_push(client, "http://d.invalid/kv/transfer", b"x")
    assert client.posts == 1 and llm.pd_stats["piece_retries"] == 0
    # an injected 4xx is a rejection too
    plan = tfaults.FaultPlan(0, [tfaults.FaultRule(site="worker.pd.push", kind="error",
                                                   status=409, match={"kind": "commit"})])
    with tfaults.active(plan):
        with pytest.raises(HTTPStatusError):
            llm._pd_push(_StubClient(), "http://d.invalid/kv/transfer",
                         b"TPUS" + bytes([1, 2]) + b"rest")
    assert llm.pd_stats["piece_retries"] == 0
