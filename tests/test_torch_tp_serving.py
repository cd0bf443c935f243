"""Tensor parallelism in the PyTorch port, serving side, on the CPU with a
gloo rank: (v) a rank that raises, or dies, fails rank 0's call with
``EngineStateLost`` naming the rank, with no hang; (vi) each refusal by
name, at the engine and at the worker; (vii) ``TorchLLMEngine`` with
``tp_size: 2, device: cpu`` serves in batcher and in direct mode as the
one-rank engine does, and hands KV to another worker. Every group has a
short timeout. The page transfers themselves (handoff, PD, the spill
tiers) are in ``test_torch_tp_handoff.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.comm.data_plane import DataPlaneServer  # noqa: E402
from distributed_gpu_inference_torch.comm.stage_worker import PipelineStageWorker  # noqa: E402
from distributed_gpu_inference_torch.models.configs import (  # noqa: E402
    get_model_config as tget,
)
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    params_from_numpy,
    shard_params_numpy,
)
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import tp as tp_ranks  # noqa: E402
from distributed_gpu_inference_torch.runtime.kv_handoff import migrate_kv_device  # noqa: E402
from distributed_gpu_inference_torch.runtime.speculative import SpecDecodeConfig  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.base import EngineLoadError  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402

MODEL = "llama3-tiny"       # num_kv_heads = 2 → tp 2
CPU2 = ["cpu", "cpu"]
GEOM = dict(max_batch_size=3, max_seq_len=128, block_size=16, prefill_buckets=(16, 32),
            dtype="float32", multi_step=4)
PROMPTS = [[(i * 7 + 3 * j) % 500 + 1 for i in range(5 + 11 * j)] for j in range(3)]


def _req(ds, prompt, n=8, **kw):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0,
                                                          **kw))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Each rank is a process of its own on the same cores (it takes the
    parent's thread count): two threads a process keep a file's ranks from
    crowding the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _short_timeout():
    """A rank that hangs fails a test in 30 s, not in the engine's 120."""
    was = tp_ranks.TIMEOUT_S
    tp_ranks.TIMEOUT_S = 30.0
    yield
    tp_ranks.TIMEOUT_S = was


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(0), jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


# -- (v) failures ----------------------------------------------------------------


def test_a_rank_that_raises_or_dies_fails_rank_0_by_name(weights, monkeypatch):
    monkeypatch.setattr(tp_ranks, "TIMEOUT_S", 10.0)
    for how in ("raise", "kill"):
        eng = tengine.TorchEngine(MODEL, tengine.EngineConfig(**GEOM),
                                  params=params_from_numpy(weights[1], "cpu"),
                                  rank_devices=CPU2)
        try:
            assert eng.generate([_req(tds, PROMPTS[0], 3)])[0].token_ids
            if how == "raise":
                eng._ranks.send("raise", message="an injected fault")
            else:
                eng._ranks._procs[0].kill()
            with pytest.raises(tengine.EngineStateLost, match="rank 1"):
                eng.generate([_req(tds, PROMPTS[1], 3)])
            # and every later call, naming it again
            with pytest.raises(tengine.EngineStateLost, match="rank 1"):
                eng.generate([_req(tds, PROMPTS[2], 3)])
        finally:
            eng.shutdown()
        assert not eng._ranks._procs[0].is_alive()


# -- (vi) refusals ----------------------------------------------------------------


def test_refusals_by_name(weights):
    cfg = tengine.EngineConfig(**GEOM)
    with pytest.raises(ValueError, match="num_kv_heads 2 not divisible by model axis 4"):
        tengine.TorchEngine(MODEL, cfg, rank_devices=["cpu"] * 4)
    moe3 = dataclasses.replace(tget("mixtral-tiny"), num_experts=3)
    with pytest.raises(ValueError, match="num_experts 3 not divisible by model axis 2"):
        tengine.TorchEngine(moe3, tengine.EngineConfig(**GEOM), rank_devices=CPU2)
    with pytest.raises(ValueError, match="speculative decode mode is single-chip"):
        tengine.TorchEngine(MODEL, tengine.EngineConfig(
            **GEOM, speculative=SpecDecodeConfig(num_draft_tokens=2)), rank_devices=CPU2)
    # a pipeline stage takes whole layers, not a rank's shard
    with pytest.raises(ValueError, match="tensor-parallel rank's shard"):
        PipelineStageWorker(MODEL, (0, 2), params=params_from_numpy(
            shard_params_numpy(weights[1], 0, 2), "cpu"), device="cpu")
    eng = tengine.TorchEngine(MODEL, tengine.EngineConfig(**GEOM),
                              params=params_from_numpy(weights[1], "cpu"), rank_devices=CPU2)
    other = tengine.TorchEngine(MODEL, tengine.EngineConfig(**GEOM),
                                params=params_from_numpy(weights[1], "cpu"), device="cpu")
    try:
        slot = eng.submit(_req(tds, PROMPTS[1], 4))
        # a device-side move between a mesh engine and an engine on other
        # devices (here one that claims a second card) is the wire path's
        # job; on the same devices it moves (tests/test_torch_tp_migrate.py)
        other.rank_devices = [torch.device("cuda", 1)]
        with pytest.raises(NotImplementedError, match="on different devices"):
            migrate_kv_device(eng, other, slot)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("config,match", [
    ({"device": "cuda", "tp_size": 2}, "tp_size=2 but only"),
    ({"tp_size": 4}, "num_kv_heads 2 not divisible by model axis 4"),
    ({"extra": {"tp_size": 2}, "speculative_decode": True}, "speculative_decode is not"),
    ({"tp_size": 2, "engine": "jax-speculative"}, "speculative decoding is single-chip"),
    ({"tp_size": 3}, "num_kv_heads 2 not divisible by model axis 3"),
])
def test_the_worker_refuses_by_name(config, match):
    if config.get("device") == "cuda" and torch.cuda.is_available() \
            and torch.cuda.device_count() >= 2:
        pytest.skip("this machine has the cards")
    llm = TorchLLMEngine(dict({"model": MODEL, "device": "cpu"}, **config))
    with pytest.raises(EngineLoadError, match=match):
        llm.load_model()
    assert llm.engine is None


# -- (vii) the LLM engine in both serving modes -------------------------------------


@pytest.mark.parametrize("mode", ["batcher", "direct"])
def test_llm_engine_serves_at_tp_size_2(weights, mode):
    base = {"model": MODEL, "device": "cpu", "dtype": "float32", "max_seq_len": 128,
            "prefill_buckets": [16, 32, 64], "serving": {"mode": mode}}
    outs = []
    for tp in (1, 2):
        llm = TorchLLMEngine(dict(base, params=params_from_numpy(weights[1], "cpu"),
                                  extra={"tp_size": tp}))
        llm.load_model()
        ranks = llm.engine._ranks
        try:
            assert llm.engine.tp == tp and (llm.serving is None) == (mode == "direct")
            assert llm.kv_migrate_enabled      # on at every tp_size, as in JAX
            outs.append([llm.inference({"prompt": p, "max_new_tokens": 6,
                                        "ignore_eos": True})["text"]
                         for p in ("hello there", "tensor parallel ranks")])
            if tp == 2:
                assert llm.engine.get_stats()["tp"]["all_reduce"] > 0
        finally:
            llm.unload()
        if tp == 2:       # unload stopped the rank
            assert not any(p.is_alive() for p in ranks._procs)
    assert outs[1] == outs[0]


def test_a_kv_handoff_between_workers_is_refused_before_any_device_work(weights):
    """The name is the refusal this test once held; the handoff is served
    now. At tp 2 a handoff to another worker streams (or sends one blob)
    and the receiving worker adopts it, each end gathering or scattering
    its ranks' heads of a page; what is still refused before any device
    work is a malformed blob."""
    def llm():
        out = TorchLLMEngine({"model": MODEL, "device": "cpu", "dtype": "float32",
                              "max_seq_len": 128, "prefill_buckets": [16, 32],
                              "serving": {"mode": "direct"}, "extra": {"tp_size": 2},
                              "params": params_from_numpy(weights[1], "cpu")})
        out.load_model()
        return out

    src, dst = llm(), llm()
    plane = DataPlaneServer(kv_receiver=dst.kv_receiver)
    plane.start()
    try:
        job = {"prompt": "hello there", "max_new_tokens": 4, "ignore_eos": True}
        want = src.inference(dict(job))["text"]
        before = dst.engine.get_stats()["tp"]["broadcast"]
        with pytest.raises(ValueError, match="malformed handoff frame"):
            dst.kv_receiver(b"not a handoff")
        assert dst.engine.get_stats()["tp"]["broadcast"] == before
        assert dst.engine.num_active == 0
        for stream in (True, False):
            key = f"w-{stream}"
            out = src.pd_prefill(dict(job, decode_url=plane.url, decode_worker="w2",
                                      target_worker="w1", kv_cache_key=key,
                                      pd_stream=stream))
            assert not out.get("local")
            assert dst.pd_decode({"kv_cache_key": key})["text"] == want
        assert dst.engine.get_stats()["tp"]["broadcast"] > before
    finally:
        plane.stop()
        src.unload()
        dst.unload()
