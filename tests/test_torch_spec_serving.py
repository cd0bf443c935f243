"""Speculative decoding as a serving path in the port, against the JAX
package on ``llama3-tiny`` in f32 on the CPU:

- the port's batcher drives a speculating ``TorchEngine`` unchanged and
  bit-exactly (multi-token commits per round, the ``spec_integrated``
  stats), and refuses a standalone decoder on such an engine;
- with a standalone ``SpeculativeDecoder`` attached, low-depth greedy load
  routes through its spec waves (results and decoder stats equal the JAX
  batcher's with the same draft head), while deep, sampled and opted-out
  load decodes on the paged engine;
- ``TorchLLMEngine`` loads ``speculative_decode: true`` and ``engine:
  jax-speculative`` and serves through both with the JAX worker engine's
  results; ``spec_distill_steps`` and the two modes together are refused
  at load by name;
- the worker's speculation heartbeat block, ingested by the JAX control
  plane (``LiveControlPlane``) as it ingests the JAX worker's."""

import asyncio
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_gpu_inference_torch.models.configs import get_model_config as tcfg  # noqa: E402
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    draft_params_from_numpy,
    params_from_numpy,
)
from distributed_gpu_inference_torch.runtime import batcher as tbatcher  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import speculative as tspec  # noqa: E402
from distributed_gpu_inference_torch.utils import config as tconfig  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.worker import api_client as tapi  # noqa: E402
from distributed_gpu_inference_torch.worker import engines as tengines  # noqa: E402
from distributed_gpu_inference_torch.worker import main as tmain  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.base import EngineLoadError  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config as jcfg  # noqa: E402
from distributed_gpu_inference_tpu.runtime import batcher as jbatcher  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import speculative as jspec  # noqa: E402
from distributed_gpu_inference_tpu.testing.harness import LiveControlPlane  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import llm as jllm  # noqa: E402

MODEL = "llama3-tiny"
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jcfg(MODEL), jax.random.PRNGKey(9), jnp.float32)
    dp = jspec.init_draft_params(jcfg(MODEL), jax.random.PRNGKey(2), dtype=jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams), dp


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _req(ds, seed_tok, n=12, temperature=0.0, opt_out=False):
    prompt = [(seed_tok * 7 + i * 13) % 500 for i in range(20)]
    r = ds.InferenceRequest(prompt_token_ids=prompt, sampling=ds.SamplingParams(
        max_new_tokens=n, temperature=temperature, seed=0 if temperature else None))
    if opt_out:
        r.params["speculative"] = False
    return r


GEOM = dict(max_batch_size=4, max_seq_len=128, block_size=16, prefill_buckets=(32,),
            dtype="float32", enable_prefix_cache=False)


# ---------------------------------------------------------------- the batcher

def test_batcher_serves_a_speculating_engine_bit_exactly(weights):
    jparams, tree, dp = weights
    want = [jengine.TPUEngine(MODEL, jengine.EngineConfig(**GEOM), params=jparams)
            .generate([_req(jds, i)], use_multi_step=True)[0].token_ids for i in range(3)]
    eng = tengine.TorchEngine(MODEL, tengine.EngineConfig(
        **GEOM, speculative=tspec.SpecDecodeConfig(
            num_draft_tokens=3,
            draft_params=draft_params_from_numpy(jax.tree.map(np.asarray, dp), "cpu"))),
        params=params_from_numpy(tree, "cpu"), device="cpu")

    async def main():
        b = tbatcher.ContinuousBatcher(eng, tbatcher.BatcherConfig(max_wait_ms=10.0))
        b.start()
        got = await asyncio.gather(*(b.submit(_req(tds, i)) for i in range(3)))
        stats = b.get_stats()
        await b.stop()
        return got, stats

    got, stats = _run(main())
    assert [g.token_ids for g in got] == want
    assert stats["spec_integrated"]["steps"] > 0 and not stats["spec_wave_active"]
    assert stats["spec_integrated"]["tokens_per_step"] >= 1.0
    # a standalone decoder on a speculating engine would draft twice
    dec = tspec.SpeculativeDecoder(MODEL, params=eng.params, spec_cfg=tspec.SpeculativeConfig(
        widths=(2,), adaptive=False), max_batch_size=2, max_seq_len=128, device="cpu")
    with pytest.raises(ValueError, match="draft twice"):
        tbatcher.ContinuousBatcher(eng, spec=dec)
    with pytest.raises(RuntimeError, match="draft twice"):
        tbatcher.BatcherServing(eng, spec=dec)


def _standalone_stack(pkg, weights):
    jparams, tree, dp = weights
    spec_cfg = dict(widths=(2, 2), adaptive=False)
    if pkg == "jax":
        cfg = jcfg(MODEL, dtype="float32")
        eng = jengine.TPUEngine(cfg, jengine.EngineConfig(**GEOM), params=jparams)
        dec = jspec.SpeculativeDecoder(cfg, params=jparams, draft_params=dp,
                                       spec_cfg=jspec.SpeculativeConfig(**spec_cfg),
                                       max_batch_size=2, max_seq_len=128,
                                       prefill_buckets=(32,))
        return eng, dec, jbatcher, jds
    cfg = tcfg(MODEL, dtype="float32")
    params = params_from_numpy(tree, "cpu")
    eng = tengine.TorchEngine(cfg, tengine.EngineConfig(**GEOM), params=params, device="cpu")
    dec = tspec.SpeculativeDecoder(
        cfg, params=params, spec_cfg=tspec.SpeculativeConfig(**spec_cfg),
        draft_params=draft_params_from_numpy(jax.tree.map(np.asarray, dp), "cpu"),
        max_batch_size=2, max_seq_len=128, prefill_buckets=(32,), device="cpu")
    return eng, dec, tbatcher, tds


def test_standalone_decoder_routes_low_depth_greedy_load_as_jax(weights):
    out = {}
    for pkg in ("jax", "port"):
        eng, dec, mod, ds = _standalone_stack(pkg, weights)

        async def main():
            b = mod.ContinuousBatcher(
                eng, mod.BatcherConfig(max_wait_ms=20.0, spec_max_batch=2), spec=dec)
            b.start()
            low = await asyncio.gather(b.submit(_req(ds, 1)), b.submit(_req(ds, 2)))
            waves_low = b.stats["spec_waves"]
            deep = await asyncio.gather(*(b.submit(_req(ds, 10 + i)) for i in range(4)))
            waves_deep = b.stats["spec_waves"]
            sampled = await b.submit(_req(ds, 20, temperature=0.7))
            opted = await b.submit(_req(ds, 21, opt_out=True))
            stats = b.get_stats()
            await b.stop()
            return ([r.token_ids for r in low + deep + [sampled, opted]],
                    (waves_low, waves_deep, stats["spec_waves"], stats["spec_completed"]),
                    stats["spec"])

        out[pkg] = _run(main())
    assert out["port"] == out["jax"]
    toks, (low, deep, final, completed), spec = out["port"]
    assert low == 1 and deep == low and final == deep and completed == 2
    assert spec["drafted"] > 0 and spec["steps"] > 0
    # the spec waves' greedy streams are the paged engine's
    eng, _, _, _ = _standalone_stack("port", weights)
    assert toks[:2] == [eng.generate([_req(tds, i)], use_multi_step=True)[0].token_ids
                        for i in (1, 2)]


# ---------------------------------------------------------------- the worker engine

def _jax_worker(monkeypatch, jparams, cfg):
    def f32_engine(name, eng_cfg, **kw):
        eng_cfg.dtype = "float32"
        return jengine.TPUEngine(name, eng_cfg, params=jparams)

    monkeypatch.setattr(jllm, "TPUEngine", f32_engine)
    return jllm.TPULLMEngine(dict(cfg))


PROMPTS = ["hello world, this is a test", "the quick brown fox " * 3, "a",
           "paged attention over ragged rounds"]


def _serve(w, jobs):
    out = [None] * len(jobs)

    def call(i):
        out[i] = w.inference(dict(jobs[i]))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(jobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=TIMEOUT)
    assert not any(th.is_alive() for th in threads)
    return out


@pytest.mark.parametrize("mode", ["speculative_decode", "jax-speculative"])
def test_worker_engine_serves_both_modes_as_the_jax_worker(weights, monkeypatch, mode):
    jparams, tree, _ = weights
    # a 200 ms admission latch: each pair of concurrent requests forms one
    # admission (and, in the standalone mode, one spec wave) in both
    # packages however the threads are scheduled
    common = dict(model=MODEL, max_batch_size=4, max_seq_len=128,
                  prefill_buckets=[16, 32, 64], prefix_summary_top_n=0,
                  serving={"max_wait_ms": 200.0})
    if mode == "speculative_decode":
        common.update(speculative_decode=True, spec_num_draft_tokens=3, spec_adaptive=True)
    else:
        common.update(engine="jax-speculative", spec_widths="2,2")
    jw = _jax_worker(monkeypatch, jparams, common)
    tw = TorchLLMEngine(dict(common, dtype="float32", device="cpu",
                             params=params_from_numpy(tree, "cpu")))
    # two at once stay within spec_max_batch (a spec wave in the
    # standalone mode); then two more, one opting out
    jobs = [{"prompt": p, "max_new_tokens": 12, "ignore_eos": True} for p in PROMPTS]
    jobs[3]["speculative"] = False
    results = {}
    try:
        for name, w in (("jax", jw), ("port", tw)):
            w.load_model()
            if name == "port" and mode == "jax-speculative":
                # the same draft head as the JAX decoder's
                tw._spec.draft_params = draft_params_from_numpy(
                    jax.tree.map(np.asarray, jw._spec.draft_params), "cpu")
            results[name] = _serve(w, jobs[:2]) + _serve(w, jobs[2:])
            results[name + " stats"] = w.serving_stats()
            results[name + " health"] = w.health()
    finally:
        jw.unload()
        tw.unload()
    for jp, tp in zip(results["jax"], results["port"]):
        assert (tp["text"], tp["usage"], tp["finish_reason"]) == \
            (jp["text"], jp["usage"], jp["finish_reason"])
    ts, js = results["port stats"], results["jax stats"]
    if mode == "speculative_decode":
        assert ts["spec_integrated"]["steps"] > 0
        es = results["port health"]["engine_stats"]
        assert es["spec_slot_steps"] > 0 and es["spec_tokens_per_step"] >= 1.0
        assert set(es) == set(results["jax health"]["engine_stats"])
    else:
        assert ts["spec_waves"] == js["spec_waves"] >= 1
        assert ts["spec"] == js["spec"]
        assert tw._spec is None            # unloaded with the engine


@pytest.mark.parametrize("config,match", [
    # draft distillation is ported: this case loads, distils and serves
    pytest.param(dict(speculative_decode=True, spec_distill_steps=50), None,
                 id="config0-spec_distill_steps"),
    (dict(speculative_decode=True, engine="jax-speculative"), "mutually exclusive"),
    (dict(speculative_decode=True, spec_num_draft_tokens=0), "speculative_decode config"),
    (dict(engine="jax-speculative", spec_widths=[4, 0]), "spec_widths"),
    (dict(speculative_decode=True, spec_oracle_accept=2.0), "oracle_accept_rate"),
])
def test_worker_engine_refuses_at_load_by_name(config, match):
    w = TorchLLMEngine(dict(model=MODEL, max_batch_size=2, max_seq_len=64, dtype="float32",
                            device="cpu", **config))
    if match is None:
        w.load_model()
        try:
            assert w.distill_losses.shape == (50,) and w.serving is not None
            out = w.inference({"prompt": "ab", "max_new_tokens": 5, "ignore_eos": True})
            assert out["usage"]["completion_tokens"] == 5
            assert w.engine.get_stats()["spec_slot_steps"] > 0
        finally:
            w.unload()
        return
    with pytest.raises(EngineLoadError, match=match):
        w.load_model()
    assert w.engine is None or w.serving is None


def test_worker_oracle_and_stream_on_a_speculating_engine():
    w = TorchLLMEngine(dict(model=MODEL, max_batch_size=2, max_seq_len=128, dtype="float32",
                            device="cpu", speculative_decode=True, spec_num_draft_tokens=4,
                            spec_oracle_accept=1.0, prefix_summary_top_n=0))
    w.load_model()
    try:
        out = w.inference({"prompt": "oracle", "max_new_tokens": 20, "ignore_eos": True})
        assert out["usage"]["completion_tokens"] == 20
        st = w.engine.get_stats()
        assert st["spec_tokens_per_step"] > 4.0
        chunks = list(w.stream({"prompt": "stream me", "max_new_tokens": 9,
                                "ignore_eos": True}))
        assert chunks[-1]["done"] and chunks[-1]["usage"]["completion_tokens"] == 9
        assert w.engine.get_stats()["spec_steps"] > st["spec_steps"]
    finally:
        w.unload()


# ---------------------------------------------------------------- the heartbeat

def test_the_plane_ingests_the_speculation_heartbeat_block(weights, monkeypatch):
    jparams, tree, _ = weights
    geom = dict(model=MODEL, max_batch_size=2, max_seq_len=128, prefill_buckets=[16, 32],
                speculative_decode=True, spec_num_draft_tokens=3)
    tengines.register_engine("llm", lambda config: TorchLLMEngine(dict(
        config, **geom, dtype="float32", device="cpu", params=params_from_numpy(tree, "cpu"))))

    class FP:
        def get_or_create(self):
            return f"spec-fp-{time.monotonic_ns()}"

    monkeypatch.setattr(tmain, "MachineFingerprint", FP)
    beats = []
    try:
        with LiveControlPlane() as cp:
            cfg = tconfig.WorkerConfig(name="spec", poll_interval_s=0.02,
                                       heartbeat_interval_s=0.2)
            worker = tmain.Worker(cfg, api=tapi.APIClient(cp.url, backoff_s=0.0),
                                  topology=tds.TpuTopology(chip_type="cpu"))
            real_hb = worker.api.heartbeat

            def heartbeat(**kw):
                resp = real_hb(**kw)
                beats.append(kw.get("engine_stats") or {})
                return resp

            worker.api.heartbeat = heartbeat
            th = threading.Thread(target=lambda: worker.start(install_signal_handlers=False),
                                  daemon=True)
            th.start()
            try:
                deadline = time.time() + TIMEOUT
                while not (worker.state.value == "idle" and "llm" in worker.engines):
                    assert time.time() < deadline and th.is_alive()
                    time.sleep(0.01)
                jid = cp.call(cp.state.store.create_job({"type": "llm", "params": {
                    "prompt": "speculate for the plane", "max_new_tokens": 12,
                    "ignore_eos": True}}))
                while not (cp.job(jid)["status"] == "completed"
                           and any(b.get("spec_slot_steps") for b in beats)):
                    assert time.time() < deadline
                    time.sleep(0.01)
                n = len(beats)
                while len(beats) < n + 1:
                    assert time.time() < deadline
                    time.sleep(0.01)
                block = worker._spec_engine_stats()
                eng = worker.engines["llm"].engine.get_stats()
                prev = dict(cp.state.metrics._spec_prev[worker.api.worker_id])
            finally:
                worker.request_shutdown()
                th.join(timeout=TIMEOUT)
                assert not th.is_alive()
    finally:
        tengines._OVERRIDES.pop("llm", None)
    assert set(block) == {"spec_accepted", "spec_drafted", "spec_slot_steps",
                          "spec_emitted", "spec_accept_rate", "spec_tokens_per_step"}
    assert {k: block[k] for k in block} == {k: eng[k] for k in block}
    assert beats[-1]["spec_slot_steps"] == block["spec_slot_steps"] > 0
    # the plane's per-worker counters sit at the heartbeat's totals
    assert prev == {k: block[k] for k in ("spec_accepted", "spec_drafted", "spec_slot_steps")}
