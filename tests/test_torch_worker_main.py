"""The port's worker process (``distributed_gpu_inference_torch/worker/
main.py``): the counterparts of the JAX worker's cases in
``tests/test_worker_main.py`` — registration, remote config, load control,
claims, process and release, lifecycle, status — with a fake API client
and a stub engine through the port's ``register_engine`` hook; the GPU
topology probe on a faked ``torch.cuda``; and what the port refuses, at
start and at engine load, with the ``llama3-tiny`` engine on the CPU
(weights carried over from the JAX package) for the engine's heartbeat
channels and the live serving-config push."""

import logging
import threading
import time
import types
from typing import Any, Dict, List, Optional

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.utils.config import (  # noqa: E402
    EngineModelConfig,
    WorkerConfig,
)
from distributed_gpu_inference_torch.utils.data_structures import (  # noqa: E402
    TpuTopology,
    WorkerState,
)
from distributed_gpu_inference_torch.worker import main as wmain  # noqa: E402
from distributed_gpu_inference_torch.worker.api_client import APIError  # noqa: E402
from distributed_gpu_inference_torch.worker.engines import (  # noqa: E402
    _OVERRIDES,
    register_engine,
)
from distributed_gpu_inference_torch.worker.engines.base import (  # noqa: E402
    BaseEngine,
    EngineLoadError,
    JobMigrated,
)
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_torch.worker.main import Worker, probe_topology  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402

CPU = TpuTopology(chip_type="cpu", num_chips=1)


class StubEngine(BaseEngine):
    def __init__(self, config=None):
        super().__init__(config)
        self.loaded = False
        self.unloaded = False

    def load_model(self):
        self.loaded = True

    def inference(self, params):
        if params.get("boom"):
            raise RuntimeError("engine exploded")
        return {"echo": params}

    def unload(self):
        self.unloaded = True


class FakeAPI:
    """The APIClient surface the Worker drives."""

    def __init__(self, jobs: Optional[List[Dict[str, Any]]] = None,
                 creds_valid: bool = False):
        self.worker_id = "w-1" if creds_valid else None
        self.auth_token = "tok" if creds_valid else None
        self.refresh_token = "ref" if creds_valid else None
        self.signing_secret = "sig" if creds_valid else None
        self.jobs = list(jobs or [])
        self.creds_valid = creds_valid
        self.completed: List[Dict[str, Any]] = []
        self.checkpoints: List[Dict[str, Any]] = []
        self.released: List[str] = []
        self.calls: List[str] = []
        self.heartbeat_response: Dict[str, Any] = {}
        self.remote_config: Dict[str, Any] = {"version": 0}

    def verify_credentials(self):
        self.calls.append("verify")
        return self.creds_valid

    def register(self, info):
        self.calls.append("register")
        self.registered_info = info
        self.worker_id, self.auth_token = "w-new", "tok2"
        self.refresh_token, self.signing_secret = "ref2", "sig2"
        return {"worker_id": "w-new", "auth_token": "tok2",
                "refresh_token": "ref2", "signing_secret": "sig2"}

    def refresh_credentials(self):
        self.calls.append("refresh")
        return {}

    def fetch_remote_config(self):
        self.calls.append("fetch_config")
        return self.remote_config

    def heartbeat(self, **kw):
        self.calls.append("heartbeat")
        self.last_heartbeat = kw
        return dict(self.heartbeat_response)

    def fetch_next_job(self):
        self.calls.append("poll")
        return self.jobs.pop(0) if self.jobs else None

    def complete_job(self, job_id, success, result=None, error=None, **kw):
        self.completed.append({"job_id": job_id, "success": success,
                               "result": result, "error": error, **kw})
        return {"ok": True}

    def checkpoint_job(self, job_id, epoch, state, migrate=False):
        self.checkpoints.append({"job_id": job_id, "epoch": epoch, "state": state,
                                 "migrate": migrate})
        return {"ok": True, "requeued": migrate}

    def release_job(self, job_id):
        self.released.append(job_id)

    def going_offline(self):
        self.calls.append("going_offline")

    def offline(self):
        self.calls.append("offline")
        return []

    def close(self):
        self.calls.append("close")


@pytest.fixture(autouse=True)
def stub_llm_engine(monkeypatch, tmp_path):
    register_engine("llm", StubEngine)
    # the fingerprint file goes to a temp dir, not the user's home
    real = wmain.MachineFingerprint
    monkeypatch.setattr(wmain, "MachineFingerprint", lambda: real(str(tmp_path / "state")))
    yield
    _OVERRIDES.pop("llm", None)


def _config(**kw) -> WorkerConfig:
    return WorkerConfig(
        task_types=["llm"],
        engines={"llm": EngineModelConfig(engine="echo", model="llama3-tiny")},
        poll_interval_s=0.01, heartbeat_interval_s=30.0, **kw,
    )


def _worker(api: FakeAPI, **cfg_kw) -> Worker:
    return Worker(_config(**cfg_kw), api=api, topology=CPU)


# -- registration and remote config -------------------------------------------


def test_register_new_worker_persists_credentials():
    api = FakeAPI()
    saved = {}
    w = Worker(_config(), api=api, on_credentials=saved.update, topology=CPU)
    w.register()
    assert "register" in api.calls
    assert saved["worker_id"] == "w-new"
    info = api.registered_info
    assert info["supported_types"] == ["llm"]
    assert info["topology"] == CPU.to_dict() and info["boot_id"] == w.boot_id
    assert "fetch_config" in api.calls


def test_machine_fingerprint_is_stable_and_persisted(tmp_path, monkeypatch):
    from distributed_gpu_inference_torch.worker.machine_id import MachineFingerprint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fp = MachineFingerprint(str(tmp_path))
    assert fp.components()["accelerator"] == "cpu-only"
    first = fp.get_or_create()
    assert len(first) == 32 and fp.load() == first
    _fake_cuda(monkeypatch)      # the hardware changed: the persisted id wins
    assert MachineFingerprint(str(tmp_path)).get_or_create() == first
    assert MachineFingerprint(str(tmp_path)).components()["accelerator"] == (
        "cuda:NVIDIA H100 80GB HBM3:1")
    assert MachineFingerprint(str(tmp_path / "other")).compute() != first


def test_register_reuses_valid_credentials():
    api = FakeAPI(creds_valid=True)
    w = _worker(api)
    w.register()
    assert "register" not in api.calls
    assert "verify" in api.calls


def test_remote_config_overrides_load_control():
    api = FakeAPI(creds_valid=True)
    api.remote_config = {
        "version": 7,
        "load_control": {"acceptance_rate": 0.5, "max_jobs_per_hour": 10,
                         "working_hours": [9, 17]},
    }
    w = _worker(api)
    w.register()
    assert w.config.config_version == 7
    assert w.config.load_control.acceptance_rate == 0.5
    assert w.config.load_control.max_jobs_per_hour == 10
    assert w.config.load_control.working_hours == (9, 17)


def test_load_engines_drops_broken_type():
    class Broken(StubEngine):
        def load_model(self):
            raise EngineLoadError("no deps")

    register_engine("embedding", Broken)
    try:
        cfg = _config()
        cfg.task_types = ["llm", "embedding"]
        w = Worker(cfg, api=FakeAPI(creds_valid=True), topology=CPU)
        w.load_engines()
        assert w.config.task_types == ["llm"]
        assert "llm" in w.engines and "embedding" not in w.engines
    finally:
        _OVERRIDES.pop("embedding", None)


def test_load_engines_drops_task_types_the_port_has_no_engine_for():
    # a task type with no engine (and no engine config) raises KeyError at
    # load and is dropped as the JAX worker drops a failed load; the five
    # types of the registry all have engines now
    cfg = _config()
    cfg.task_types = ["llm", "tts", "rerank"]
    w = Worker(cfg, api=FakeAPI(creds_valid=True), topology=CPU)
    w.load_engines()
    assert w.config.task_types == ["llm"]
    cfg2 = _config()
    cfg2.task_types = ["tts"]
    with pytest.raises(EngineLoadError, match="no engine loaded"):
        Worker(cfg2, api=FakeAPI(creds_valid=True), topology=CPU).load_engines()


def test_heartbeat_config_changed_triggers_refetch():
    api = FakeAPI(creds_valid=True)
    w = _worker(api)
    w.load_engines()
    api.heartbeat_response = {"config_changed": True}
    w._heartbeat_once()
    assert api.calls.count("fetch_config") == 1
    assert w.stats["heartbeats"] == 1


def test_heartbeat_401_refreshes_token():
    api = FakeAPI(creds_valid=True)

    def bad_heartbeat(**kw):
        api.calls.append("heartbeat")
        raise APIError(401, "expired")

    api.heartbeat = bad_heartbeat
    w = _worker(api)
    w._heartbeat_once()
    assert "refresh" in api.calls
    assert "register" not in api.calls


def test_heartbeat_401_with_failed_refresh_reregisters():
    api = FakeAPI(creds_valid=True)
    api.heartbeat = lambda **kw: (_ for _ in ()).throw(APIError(401, "expired"))

    def bad_refresh():
        api.calls.append("refresh")
        raise APIError(401, "invalid refresh token")

    api.refresh_credentials = bad_refresh
    api.creds_valid = False
    w = _worker(api)
    w._heartbeat_once()
    assert api.calls[:2] == ["refresh", "register"]
    assert api.registered_info["boot_id"] == w.boot_id


def test_heartbeat_reports_stale_claims():
    api = FakeAPI(creds_valid=True)
    w = _worker(api)
    w.current_job_id = "j1"
    api.heartbeat_response = {"stale_job": True, "stale_jobs": ["j2", "j3"]}
    w._heartbeat_once()
    assert w.stats["stale_claims"] == 3


# -- job processing and claims --------------------------------------------------


def test_process_job_success_and_failure():
    api = FakeAPI(creds_valid=True)
    w = _worker(api)
    w.load_engines()
    w.state = WorkerState.IDLE
    assert w.try_begin_job()
    w.process_job({"id": "j1", "type": "llm", "params": {"x": 1}})
    assert api.completed[0]["success"] is True
    assert api.completed[0]["result"] == {"echo": {"x": 1}}
    assert w.stats["jobs_completed"] == 1
    assert w.state == WorkerState.IDLE

    assert w.try_begin_job()
    w.process_job({"id": "j2", "type": "llm", "params": {"boom": True}})
    assert api.completed[1]["success"] is False
    assert "exploded" in api.completed[1]["error"]
    assert w.stats["jobs_failed"] == 1


def test_process_job_scrubs_reserved_keys_and_fences_the_epoch():
    api = FakeAPI(creds_valid=True)
    w = _worker(api)
    w.load_engines()
    w.engines["llm"].supports_failover = True
    w.state = WorkerState.IDLE
    assert w.try_begin_job()
    w.process_job({"id": "j1", "type": "llm", "priority": 5, "assignment_epoch": 4,
                   "checkpoint": {"v": 1},
                   "params": {"x": 1, "_failover_ctx": {"key": "forged"},
                              "_flight_tl": 1, "_flight_picked_up_ts": 2}})
    done = api.completed[0]
    assert done["assignment_epoch"] == 4
    assert done["result"] == {"echo": {"x": 1, "priority": 5, "_failover_ctx": {
        "key": "j1", "kind": "job", "epoch": 4, "checkpoint": {"v": 1}}}}


def test_job_migrated_is_pushed_back_as_a_migrate_checkpoint():
    class Migrating(StubEngine):
        def inference(self, params):
            raise JobMigrated({"generated": [1, 2, 3]}, tokens=3)

    register_engine("llm", Migrating)
    api = FakeAPI(creds_valid=True)
    w = _worker(api)
    w.load_engines()
    w.state = WorkerState.IDLE
    assert w.try_begin_job()
    w.process_job({"id": "j1", "type": "llm", "assignment_epoch": 2, "params": {}})
    assert api.checkpoints == [{"job_id": "j1", "epoch": 2,
                                "state": {"generated": [1, 2, 3]}, "migrate": True}]
    assert api.completed == [] and w.stats["jobs_migrated"] == 1
    assert w.state == WorkerState.IDLE


def test_job_failing_during_shutdown_is_released_not_failed():
    api = FakeAPI(creds_valid=True)
    w = _worker(api)
    w.load_engines()
    w.state = WorkerState.IDLE
    assert w.try_begin_job()
    w._shutdown.set()
    w.process_job({"id": "j9", "type": "llm", "params": {"boom": True}})
    assert api.released == ["j9"] and api.completed == []
    assert w.stats["jobs_released_on_shutdown"] == 1


def test_try_begin_job_excludes_concurrent_work():
    w = _worker(FakeAPI(creds_valid=True))
    w.state = WorkerState.IDLE
    assert w.try_begin_job()
    assert not w.try_begin_job()        # second claim refused while BUSY
    w.end_job()
    assert w.try_begin_job()


def test_shared_claims_coexist_up_to_capacity_and_never_with_exclusive():
    w = _worker(FakeAPI(creds_valid=True))
    w.config.load_control.max_concurrent_jobs = 3
    w.state = WorkerState.IDLE
    assert [w.try_begin_serving() for _ in range(4)] == [True, True, True, False]
    assert not w.try_begin_job()
    for _ in range(3):
        w.end_serving()
    assert w.state == WorkerState.IDLE and w.try_begin_job()
    assert not w.try_begin_serving()


def test_process_job_unknown_type_fails_cleanly():
    api = FakeAPI(creds_valid=True)
    w = _worker(api)
    w.load_engines()
    w.state = WorkerState.IDLE
    assert w.try_begin_job()
    w.process_job({"id": "j3", "type": "tts", "params": {}})
    assert api.completed[0]["success"] is False


# -- load control ------------------------------------------------------------------


def test_load_control_acceptance_rate_zero_rejects():
    w = _worker(FakeAPI(creds_valid=True))
    w.config.load_control.acceptance_rate = 0.0
    assert w.should_accept_job({"type": "llm"}) is False


def test_load_control_hourly_cap():
    w = _worker(FakeAPI(creds_valid=True))
    w.config.load_control.max_jobs_per_hour = 2
    now = time.time()
    w._hour_window = [now - 10, now - 20]
    assert w.should_accept_job({"type": "llm"}, now=now) is False
    w._hour_window = [now - 4000, now - 20]     # stale entries roll out
    assert w.should_accept_job({"type": "llm"}, now=now) is True


def test_load_control_cooldown():
    w = _worker(FakeAPI(creds_valid=True))
    w.config.load_control.cooldown_seconds = 30.0
    w._last_job_done_at = time.time() - 5
    assert w.should_accept_job({"type": "llm"}) is False
    w._last_job_done_at = time.time() - 60
    assert w.should_accept_job({"type": "llm"}) is True


def test_load_control_working_hours():
    w = _worker(FakeAPI(creds_valid=True))
    hour = time.localtime().tm_hour
    w.config.load_control.working_hours = ((hour + 1) % 24, (hour + 2) % 24)
    assert w.should_accept_job({"type": "llm"}) is False
    w.config.load_control.working_hours = (hour, (hour + 1) % 24)
    assert w.should_accept_job({"type": "llm"}) is True


def test_gated_worker_never_claims():
    api = FakeAPI(creds_valid=True, jobs=[{"id": "jx", "type": "llm", "params": {}}])
    w = _worker(api)
    w.load_engines()
    w.state = WorkerState.IDLE
    w.config.load_control.acceptance_rate = 0.0
    assert w._poll_once() is False
    assert "poll" not in api.calls          # never even fetched
    assert api.jobs                          # job still queued


def test_type_weight_release_is_one_shot():
    api = FakeAPI(creds_valid=True, jobs=[{"id": "jw", "type": "llm", "params": {}},
                                          {"id": "jw", "type": "llm", "params": {}}])
    w = _worker(api)
    w.load_engines()
    w.state = WorkerState.IDLE
    w.config.load_control.job_type_weights = {"llm": 0.0}  # always throttle
    assert w._poll_once() is False
    assert api.released == ["jw"]
    assert w._poll_once() is True                            # taken this time
    assert api.completed[0]["job_id"] == "jw"


def test_rejected_job_released_not_failed():
    api = FakeAPI(creds_valid=True, jobs=[{"id": "jr", "type": "llm", "params": {}}])
    w = _worker(api)
    w.load_engines()
    w.state = WorkerState.IDLE
    w.config.load_control.job_type_weights = {"llm": 0.0}
    assert w._poll_once() is False
    assert w.stats["jobs_rejected"] == 1
    assert api.completed == [] and api.released == ["jr"]
    assert w.state == WorkerState.IDLE


# -- lifecycle and status -------------------------------------------------------------


def test_full_lifecycle_processes_jobs_then_drains():
    api = FakeAPI(creds_valid=True, jobs=[{"id": "a", "type": "llm", "params": {"n": 1}},
                                          {"id": "b", "type": "llm", "params": {"n": 2}}])
    w = _worker(api)
    t = threading.Thread(target=lambda: w.start(install_signal_handlers=False))
    t.start()
    deadline = time.time() + 10
    while len(api.completed) < 2 and time.time() < deadline:
        time.sleep(0.01)
    w.request_shutdown()
    t.join(timeout=10)
    assert not t.is_alive()
    assert [c["job_id"] for c in api.completed] == ["a", "b"]
    assert "going_offline" in api.calls and "offline" in api.calls
    assert "close" in api.calls
    assert w.state == WorkerState.OFFLINE
    assert w.engines["llm"].unloaded


@pytest.mark.parametrize("field,value,names", [
    ("role", "prefill", "role"),
    ("role", "decode", "role"),
    ("pd_data_plane_url", "http://127.0.0.1:{port}", "data_plane_url"),
])
def test_start_refuses_what_the_port_does_not_serve(field, value, names):
    """The PD settings the port once refused at start now start the
    worker: the role and the data-plane URL ride the registration, and the
    URL's port serves the KV data plane."""
    import http.client
    import json
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    value = value.format(port=port)
    api = FakeAPI()
    w = Worker(_config(**{field: value}), api=api, topology=CPU)
    w.start(install_signal_handlers=False, block=False)
    try:
        assert "register" in api.calls
        assert api.registered_info[names] == value
        if field == "pd_data_plane_url":
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("GET", "/health")
            r = conn.getresponse()
            assert r.status == 200 and json.loads(r.read())["pd_kv_receiver"] is True
            conn.close()
        else:
            assert w._pd_plane is None
    finally:
        w.request_shutdown()
        w._finalize_shutdown()
    assert w._pd_plane is None or w._pd_plane._httpd is None


def _fake_cuda(monkeypatch, name="NVIDIA H100 80GB HBM3", count=1, total=85_031_714_816):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i=0: types.SimpleNamespace(total_memory=total))


def test_probe_topology_reads_the_card(monkeypatch):
    _fake_cuda(monkeypatch)
    topo = probe_topology()
    assert topo.chip_type == "NVIDIA H100 80GB HBM3" and topo.num_chips == 1
    assert topo.hbm_gb_per_chip == pytest.approx(79.19, abs=0.01)
    assert topo.peak_bf16_tflops == 989.0 and topo.ici_bandwidth_gbps == 900.0
    assert topo.mesh_shape == (1,)
    # an unlisted card reports no made-up rates
    _fake_cuda(monkeypatch, name="Some Other GPU", count=2)
    other = probe_topology()
    assert (other.num_chips, other.peak_bf16_tflops, other.mesh_shape) == (2, 0.0, (2,))


def test_probe_topology_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_topology()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker(_config(), api=FakeAPI(creds_valid=True))   # never registers as a CPU worker


def test_topology_record_keys_match_the_jax_package():
    from distributed_gpu_inference_tpu.utils.data_structures import TpuTopology as JTopo

    assert set(CPU.to_dict()) == set(JTopo().to_dict())


def test_get_status_shape():
    w = _worker(FakeAPI(creds_valid=True))
    st = w.get_status()
    assert st["state"] == "initializing"
    assert st["task_types"] == ["llm"]
    assert st["topology"] == CPU.to_dict() and "stats" in st


def test_wizard_reports_the_card(monkeypatch):
    from distributed_gpu_inference_torch.worker.cli import ConfigWizard

    _fake_cuda(monkeypatch)
    lines = []
    cfg = ConfigWizard(input_fn=lambda p: "", print_fn=lines.append).run()
    assert isinstance(cfg, WorkerConfig)
    assert any("detected accelerator: NVIDIA H100 80GB HBM3 x1" in line for line in lines)


# -- the llama3-tiny engine behind the worker (CPU, JAX weights) ---------------------


@pytest.fixture(scope="module")
def tiny_params():
    jparams = jllama.init_params(get_model_config("llama3-tiny"), jax.random.PRNGKey(3),
                                 jnp.float32)
    return jax.tree.map(np.asarray, jparams)


def _tiny_factory(tiny_params):
    def make(config):
        return TorchLLMEngine(dict(config, dtype="float32", device="cpu",
                                   max_batch_size=4, max_seq_len=128,
                                   prefill_buckets=[16, 32, 64],
                                   params=params_from_numpy(tiny_params, "cpu")))
    return make


def test_heartbeat_carries_the_engine_channels(tiny_params):
    register_engine("llm", _tiny_factory(tiny_params))
    api = FakeAPI(creds_valid=True)
    w = _worker(api)
    w.load_engines()
    try:
        llm = w.engines["llm"]
        llm.inference({"prompt": "a shared system prompt " * 4, "max_new_tokens": 4})
        api.heartbeat_response = {"prefix_summary_resync": False}
        w._heartbeat_once()
        es = api.last_heartbeat["engine_stats"]
        assert es["batcher"]["capacity"] == w.serving_capacity() == 4
        assert es["batcher"]["completed"] == 1
        assert {"preemptions", "resumes", "kv_pressure_events"} <= set(es)
        assert es["prefix_summary"]["full"] and es["prefix_summary_live"] is True
        w._heartbeat_once()                  # acked: in sync, no payload
        assert "prefix_summary" not in api.last_heartbeat["engine_stats"]
        api.heartbeat_response = {"plane_id": "p1"}
        w._heartbeat_once()
        api.heartbeat_response = {"plane_id": "p2"}
        w._heartbeat_once()                  # another plane: full resync next
        assert w.stats["plane_failovers"] == 1
        api.heartbeat_response = {"prefix_summary_applied": False}
        w._heartbeat_once()
        assert llm.prefix_hot is None        # a plane that can never apply it
    finally:
        w.engines["llm"].unload()


def test_serving_config_push_reaches_the_batcher_and_refusals_are_logged(
        tiny_params, caplog):
    register_engine("llm", _tiny_factory(tiny_params))
    api = FakeAPI(creds_valid=True)
    w = _worker(api)
    w.load_engines()
    llm = w.engines["llm"]
    try:
        api.remote_config = {"version": 2, "serving": {"target_step_ms": 40.0,
                                                       "queue_limit": 7}}
        w._fetch_remote_config()
        deadline = time.time() + 10
        while llm.serving.batcher.cfg.queue_limit != 7 and time.time() < deadline:
            time.sleep(0.01)
        assert llm.serving.batcher.cfg.target_step_latency_ms == 40.0
        assert llm.serving.batcher.cfg.queue_limit == 7
        # deadline abandonment is served now: the push turns it on live
        api.remote_config = {"version": 3, "serving": {"abandon_deadlines": "true",
                                                       "deadline_grace_s": 0.25}}
        w._fetch_remote_config()
        deadline = time.time() + 10
        while not llm.serving.batcher.cfg.abandon_deadlines and time.time() < deadline:
            time.sleep(0.01)
        assert llm.serving.batcher.cfg.abandon_deadlines is True
        assert llm.serving.batcher.cfg.deadline_grace_s == 0.25
        # a value the batcher rejects is logged as a rejected push
        api.remote_config = {"version": 4, "serving": {"ragged_chunk": 0}}
        with caplog.at_level(logging.WARNING):
            w._fetch_remote_config()
            deadline = time.time() + 10
            while "serving config push rejected" not in caplog.text \
                    and time.time() < deadline:
                time.sleep(0.01)
        assert "serving config push rejected" in caplog.text
        assert "ragged_chunk must be >= 1" in caplog.text
    finally:
        llm.unload()


@pytest.mark.parametrize("config,names", [
    # the speculative modes load since they were ported, and since draft
    # distillation was ported spec_distill_steps loads, distils and serves
    # (names None); what stays refused is both modes at once (ids kept)
    pytest.param({"engine": "jax-speculative", "speculative_decode": True},
                 "engine=jax-speculative", id="config0-jax-speculative"),
    pytest.param({"engine": "speculative", "speculative_decode": True}, "mutually exclusive",
                 id="config1-engine: speculative"),
    pytest.param({"speculative_decode": True, "spec_distill_steps": 100},
                 None, id="config2-speculative_decode"),
    # extra.tp_size: 2 loads and serves over two CPU ranks since tensor
    # parallelism was ported (id kept); a mesh the model cannot take is
    # refused with the JAX engine's reason (tp_size 4 below)
    pytest.param({"extra": {"tp_size": 2}}, None, id="config3-extra.tp_size=2"),
    # serving.mode: direct loads and serves since it was ported (id kept);
    # a mode that is neither batcher nor direct is refused by name
    pytest.param({"serving": {"mode": "direct"}}, None, id="config4-serving.mode"),
    pytest.param({"serving": {"mode": "pipeline"}}, "serving.mode: 'pipeline'",
                 id="serving.mode-unknown"),
    # a local tokenizer directory loads; a hub id (not a local directory)
    # is refused, since the port downloads nothing
    ({"tokenizer_id": "meta-llama/Meta-Llama-3-8B"}, "tokenizer_id"),
    pytest.param({"tp_size": 4}, "num_kv_heads 2 not divisible by model axis 4",
                 id="config7-extra.tp_size=4"),
    # an HF directory loads; an orbax one is JAX-only
    pytest.param({"checkpoint_path": "<orbax>"}, "orbax checkpoints are JAX-only",
                 id="checkpoint_path-orbax"),
])
def test_engine_refuses_at_load_what_the_port_does_not_serve(config, names, tmp_path):
    if config.get("checkpoint_path") == "<orbax>":
        # the layout orbax's StandardCheckpointer writes: no config.json and
        # no *.safetensors at the top
        (tmp_path / "params").mkdir()
        (tmp_path / "params" / "_CHECKPOINT_METADATA").write_text("{}")
        (tmp_path / "model_config.json").write_text("{}")
        config = {"checkpoint_path": str(tmp_path)}
    llm = TorchLLMEngine(dict({"model": "llama3-tiny", "device": "cpu"}, **config))
    if names is None:
        llm.load_model()
        try:
            if "spec_distill_steps" in config:
                assert llm.distill_losses.shape == (config["spec_distill_steps"],)
            elif "extra" in config:                 # two tensor-parallel ranks
                assert llm.engine.tp == 2 and llm.serving is not None
            else:                                   # direct mode: no batcher
                assert llm.serving is None and llm.serving_stats() is None
            out = llm.inference({"prompt": "hi", "max_new_tokens": 4, "ignore_eos": True})
            assert out["usage"]["completion_tokens"] == 4
        finally:
            llm.unload()
        return
    with pytest.raises(EngineLoadError, match=names):
        llm.load_model()
    assert llm.engine is None


@pytest.mark.parametrize("config", [
    {"serving": {"abandon_deadlines": True}},
    {"serving": {"abandon_deadlines": True, "predictive_abandon": True}},
    {"kv_spill_host_blocks": 64},
    {"kv_spill_host_blocks": 4, "kv_remote_url": "memory://", "kv_remote_ttl_s": 60},
    {"speculative_decode": True, "spec_num_draft_tokens": 2},
    {"engine": "jax-speculative", "spec_widths": [2, 2]},
])
def test_engine_loads_and_serves_the_lifted_keys(tiny_params, config):
    llm = TorchLLMEngine(dict({"model": "llama3-tiny", "device": "cpu",
                               "dtype": "float32", "max_seq_len": 128,
                               "prefill_buckets": [16, 32, 64],
                               "params": params_from_numpy(tiny_params, "cpu")},
                              **config))
    llm.load_model()
    try:
        out = llm.inference({"prompt": "lifted", "max_new_tokens": 4,
                             "ignore_eos": True})
        assert out["usage"]["completion_tokens"] == 4
        bc = llm.serving.batcher.cfg
        sv = config.get("serving", {})
        assert bc.abandon_deadlines is bool(sv.get("abandon_deadlines"))
        assert bc.predictive_abandon is bool(sv.get("predictive_abandon"))
        mgr = llm.engine.manager
        assert (mgr.host_store is not None) == bool(config.get("kv_spill_host_blocks"))
        assert (mgr.remote_store is not None) == bool(config.get("kv_remote_url"))
        assert mgr.spill_on_evict == bool(config.get("kv_spill_host_blocks"))
    finally:
        llm.unload()


def test_worker_drops_an_llm_engine_config_the_port_refuses(tiny_params):
    register_engine("llm", _tiny_factory(tiny_params))
    cfg = _config()
    # a mesh llama3-tiny's two KV heads cannot take (tp_size 2 loads since
    # tensor parallelism was ported)
    cfg.engines["llm"] = EngineModelConfig(
        engine="jax", model="llama3-tiny", extra={"tp_size": 4})
    with pytest.raises(EngineLoadError, match="no engine loaded"):
        Worker(cfg, api=FakeAPI(creds_valid=True), topology=CPU).load_engines()


# -- the radix prefix summary ------------------------------------------------------


PROMPTS = ["a shared system prompt " * 6, "a shared system prompt " * 6 + "then more",
           "ünïcödé prompt text, " * 8, "x" * 63, "y" * 64,
           [{"role": "system", "content": "be brief " * 12},
            {"role": "user", "content": "hello"}]]


def test_prefix_summary_wire_matches_the_jax_package():
    from distributed_gpu_inference_torch.runtime.prefix_summary import PrefixHotSet
    from distributed_gpu_inference_tpu.runtime.prefix_summary import PrefixHotSet as JHot

    port, ref = PrefixHotSet(top_n=10), JHot(top_n=10)
    script = [("wire",), ("note", 0), ("wire",), ("ack",), ("note", 1), ("note", 2),
              ("wire",), ("resync",), ("wire",), ("ack",), ("note", 3), ("note", 4),
              ("note", 5), ("wire",), ("ack",), ("drop", 0.3), ("wire",), ("ack",),
              ("demote", 0.5), ("wire",), ("note", 0), ("wire",)]
    for step in script:
        outs = []
        for hot in (port, ref):
            if step[0] == "note":
                outs.append(hot.note(PROMPTS[step[1]]))
            elif step[0] in ("drop", "demote"):
                outs.append(getattr(hot, step[0])(step[1]))
            else:
                outs.append(getattr(hot, step[0])())
        assert outs[0] == outs[1], step
    assert port.snapshot() == ref.snapshot() and len(port) > 0


def test_the_summary_drops_what_the_pool_evicted(tiny_params):
    # no spill tier: evicted KV is gone, so its entries leave the summary
    llm = _tiny_factory(tiny_params)({"model": "llama3-tiny", "num_blocks": 12})
    llm.load_model()
    try:
        llm.inference({"prompt": PROMPTS[0], "max_new_tokens": 2})
        assert llm.prefix_summary_wire()["full"]
        llm.prefix_summary_ack()
        before = len(llm.prefix_hot)
        for i in range(3):          # fresh 150-token prompts push the first out
            llm.inference({"prompt": f"{i} " + "z" * 150, "max_new_tokens": 2})
        assert llm.engine.manager.stats.evictions > 0
        wire = llm.prefix_summary_wire()
        assert wire["del"] and len(llm.prefix_hot) < before + 3 * 2
        assert all(t == "dev" for _, _, t in wire["add"])
    finally:
        llm.unload()
