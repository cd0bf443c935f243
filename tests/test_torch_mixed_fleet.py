"""One fleet of both packages: a JAX ``FleetWorker`` (``TPULLMEngine``) and
a port ``FleetWorker`` (``TorchLLMEngine``) behind one JAX
``LiveControlPlane``, built by the port's ``LiveFleet`` through its
``member_factory``, both serving ``llama3-tiny`` on the same weights (drawn
once by the JAX initializer, carried to the port through
``models/convert.py``) in f32 compute — bf16 on the CPU rounds differently
in XLA and torch.

Each member is killed in turn while it holds a job mid-generation (the
engine rounds are paced while chaos runs), under a workload of queued jobs
and direct streams (the JAX SDK's ``InferenceClient``), and restarted once
the other member has taken its work: jobs the one package started are
resumed by the other from their checkpoints. Every job completes exactly
once, every stream ends with ``done`` and gapless offsets, and every output
is byte-identical to a calm replay on the same fleet, whichever package
served or resumed it."""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.testing import harness as tharness  # noqa: E402
from distributed_gpu_inference_torch.testing.faults import FleetEvent, FleetFaultPlan  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.testing import harness as jharness  # noqa: E402
from distributed_gpu_inference_tpu.worker import direct_server as jdirect  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import llm as jllm  # noqa: E402
from tests.test_torch_fleet_chaos import (  # noqa: E402
    FLEET_ENGINE,
    assert_no_lost_or_duplicated_jobs,
    await_quiet,
    calm_reference,
    drive_open_loop,
    heal,
    metric,
    paced,
    port_fleet,
    suite_prompts,
)

MODEL = "llama3-tiny"
# while chaos runs each engine round sleeps this long first, so a kill
# lands while the victim holds a job mid-generation with a checkpoint on
# the plane (the calm replay runs unpaced); one dict a member, so the
# victim alone can be held back while its kill lands
PACE = {"s": 0.15}
# a batch and a claim ceiling of 8: a request whose member dies finds
# headroom on the survivor (the plane offers no failover worker without)
ENGINE = {**FLEET_ENGINE, "max_batch_size": 8}


@pytest.fixture(scope="module")
def mixed():
    jparams = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(5), jnp.float32)
    weights = jax.tree.map(np.asarray, jparams)

    def f32_engine(name, eng_cfg, **kw):
        eng_cfg.dtype = "float32"
        return jengine.TPUEngine(name, eng_cfg, params=jparams)

    jax_engine = {k: v for k, v in ENGINE.items() if k not in ("device", "dtype")}

    def member(index, target, role):
        if index == 0:
            return paced(jharness.FleetWorker, PACE, 8)(index, target, jax_engine)
        return paced(tharness.FleetWorker, PACE, 8)(index, target, ENGINE, weights=weights)

    real_stop = jdirect.DirectServer.stop

    def patient_stop(self):
        # the JAX member's kill stops its server, then its engine; the
        # server's shutdown lets the streams in flight run on (they end with
        # done), but the kill waits for it only 5 s, after which the engine's
        # stop fails a stream still running with an error event instead of a
        # drop. Here the kill waits until its server is down, whatever the load
        thread = self._thread
        real_stop(self)
        if thread is not None:
            thread.join(timeout=120.0)

    with pytest.MonkeyPatch.context() as mp:
        # every (re)start of the JAX member builds its engine on the weights
        mp.setattr(jllm, "TPUEngine", f32_engine)
        mp.setattr(jdirect.DirectServer, "stop", patient_stop)
        # a member is declared dead after 3 s without a heartbeat (the
        # harness's 0.9 s is under five of its 0.2 s beats): beside other
        # test processes a live member's heartbeat thread can stall past
        # 0.9 s, and the plane then requeues the jobs it is running, so the
        # victim never holds one until its kill
        with port_fleet(n=2, member_factory=member, heartbeat_timeout_s=3.0) as fl:
            yield fl


def test_members_are_one_of_each_package(mixed):
    kinds = [type(m).__mro__[1].__module__.split(".")[0] for m in mixed.members]
    assert kinds == ["distributed_gpu_inference_tpu", "distributed_gpu_inference_torch"]
    assert all(m.alive and m.worker_id for m in mixed.members)


def _kill_while_busy(mixed, victim, seed):
    """Traffic of 6 requests (every third a stream); once the victim holds
    a running job whose checkpoint reached the plane, its next round is
    held back and it is killed, and restarted once those jobs have gone to
    the other member. → (records, the job ids this traffic created)."""
    prompts = suite_prompts(seed, 6)
    out, errors = {}, []

    def traffic():
        try:
            out["records"] = drive_open_loop(mixed, prompts, seed=seed, max_tokens=16,
                                             rate=50.0)
        except BaseException as exc:  # noqa: BLE001 — raised below
            errors.append(exc)

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    vid = mixed.members[victim].worker_id
    other = mixed.members[1 - victim].worker_id
    held = []

    def holding():
        rows = mixed.plane.query(
            "SELECT id FROM jobs WHERE status='running' AND worker_id=?", (vid,))
        held[:] = [r["id"] for r in rows
                   if (mixed.plane.job(r["id"]).get("checkpoint") or {}).get("generated")]
        return bool(held)

    llm = mixed.members[victim].llm

    def generating():
        # the victim's running jobs that have generated tokens: the next
        # heartbeat carries their checkpoints (``checkpoint_live``)
        live = {e["key"] for e in llm.checkpoint_live()
                if e["kind"] == "job" and e["state"].get("generated")}
        rows = mixed.plane.query(
            "SELECT id FROM jobs WHERE status='running' AND worker_id=?", (vid,))
        return [r["id"] for r in rows if r["id"] in live]

    # a round of the victim that starts while it holds a checkpointed job
    # waits at a gate, so under any load that job is still running when the
    # kill lands; the gate opens once the plane gave the jobs to the other
    # member (the dying incarnation's round then runs out, and its late
    # completion is fenced). Job checkpoints reach the plane on the
    # heartbeat, not with the round: a round that starts while a job has
    # generated tokens the plane has not seen yet first waits for the
    # heartbeat that carries them, or a job that finishes within a few
    # rounds under CPU contention is never held
    gate = threading.Event()
    eng = llm.engine
    for name in ("ragged_round", "decode_multi"):
        def gated(*a, _real=getattr(eng, name), **kw):
            if not gate.is_set():
                deadline = time.time() + 30.0
                while not holding() and generating() and time.time() < deadline:
                    time.sleep(0.02)
                if held:
                    gate.wait(timeout=120.0)
            return _real(*a, **kw)

        setattr(eng, name, gated)
    deadline = time.time() + 60.0
    while not list(held):
        assert time.time() < deadline, "the victim never held a checkpointed job"
        time.sleep(0.02)
    plan = FleetFaultPlan(seed, n_workers=2, duration_s=1.0)
    plan.events = [FleetEvent(0.0, "kill", victim)]
    mixed.run_chaos(plan)

    def taken():
        return all(mixed.plane.job(j)["worker_id"] == other
                   and mixed.plane.job(j)["assignment_epoch"] >= 2 for j in held)

    # restarted only once the other member took the jobs it held: a restart
    # that beats the other member's claim would take them back itself
    deadline = time.time() + 120.0
    while not taken():
        assert time.time() < deadline, (
            "the killed member's jobs never went to the other member",
            {j: {k: mixed.plane.job(j).get(k) for k in ("status", "worker_id",
                                                         "assignment_epoch")}
             for j in held})
        time.sleep(0.05)
    gate.set()
    mixed.wait_chaos(timeout_s=180.0)
    restart = FleetFaultPlan(seed, n_workers=2, duration_s=1.0)
    restart.events = [FleetEvent(0.0, "restart", victim)]
    mixed.run_chaos(restart)
    t.join(timeout=180.0)
    mixed.wait_chaos(timeout_s=180.0)
    heal(mixed)
    if errors:
        raise errors[0]
    assert [k for _, k, _ in plan.trace + restart.trace] == ["kill", "restart"]
    return out["records"], {r["job_id"] for r in out["records"] if r["path"] == "queued"}


def test_kill_each_package_in_turn_outputs_byte_identical(mixed):
    ids = [m.worker_id for m in mixed.members]
    records, resumed_by = [], {}
    for victim, seed in ((0, 1), (1, 2)):
        recs, jobs = _kill_while_busy(mixed, victim, seed)
        records += recs
        other = ids[1 - victim]
        # the victim's jobs were requeued with their checkpoints and the
        # other package's member resumed them
        resumed_by[victim] = [
            j for j in jobs
            if mixed.plane.job(j)["assignment_epoch"] >= 2
            and mixed.plane.job(j)["worker_id"] == other
            and (mixed.plane.job(j).get("checkpoint") or {}).get("generated")]
    assert resumed_by[0] and resumed_by[1], resumed_by
    # each member re-registered onto its own plane row
    assert [m.worker_id for m in mixed.members] == ids
    await_quiet(mixed)
    assert_no_lost_or_duplicated_jobs(mixed)
    PACE["s"] = 0.0
    calm_reference(mixed, records, max_tokens=16)
    assert "chaos_kills_total 2.0" in metric(mixed.plane, "chaos_kills_total")
