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
# the plane (the calm replay runs unpaced)
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

    with pytest.MonkeyPatch.context() as mp:
        # every (re)start of the JAX member builds its engine on the weights
        mp.setattr(jllm, "TPUEngine", f32_engine)
        with port_fleet(n=2, member_factory=member) as fl:
            yield fl


def test_members_are_one_of_each_package(mixed):
    kinds = [type(m).__mro__[1].__module__.split(".")[0] for m in mixed.members]
    assert kinds == ["distributed_gpu_inference_tpu", "distributed_gpu_inference_torch"]
    assert all(m.alive and m.worker_id for m in mixed.members)


def _kill_while_busy(mixed, victim, seed):
    """Traffic of 6 requests (every third a stream); once the victim holds
    a running job whose checkpoint reached the plane, it is killed, and
    restarted after its jobs have gone to the other member. → (records,
    the job ids this traffic created)."""
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

    def holding():
        rows = mixed.plane.query(
            "SELECT id FROM jobs WHERE status='running' AND worker_id=?", (vid,))
        return any((mixed.plane.job(r["id"]).get("checkpoint") or {}).get("generated")
                   for r in rows)

    deadline = time.time() + 60.0
    while not holding():
        assert time.time() < deadline, "the victim never held a checkpointed job"
        time.sleep(0.02)
    plan = FleetFaultPlan(seed, n_workers=2, duration_s=4.0)
    plan.events = [FleetEvent(0.0, "kill", victim), FleetEvent(3.0, "restart", victim)]
    mixed.run_chaos(plan)
    t.join(timeout=180.0)
    mixed.wait_chaos(timeout_s=180.0)
    heal(mixed)
    if errors:
        raise errors[0]
    assert [k for _, k, _ in plan.trace] == ["kill", "restart"]
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
