"""``TorchEngine`` (CPU, f32, plain attention) against ``TPUEngine`` on
``llama3-tiny`` with the same weights: identical greedy streams for
``generate`` (per-step and multi-step), for ragged rounds with mixed
admissions and per-round chunk caps followed by ``decode_multi``, and for
prefix-cache hits; ``TorchLLMEngine.inference`` through ``BatcherServing``
against the JAX worker engine with concurrent callers. Also the port's own
contracts: preempt/resume continues byte-identically, copy-on-write copies
land on every layer, and a failed in-place round leaves the engine loudly
unusable."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
GEOM = dict(max_batch_size=4, max_seq_len=128, prefill_buckets=(16, 32, 64),
            multi_step=8, dtype="float32")


@pytest.fixture(scope="module")
def weights():
    cfg = get_model_config(MODEL)
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(7), jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


def _pair(weights, **over):
    jparams, tree = weights
    geom = {**GEOM, **over}
    j = jengine.TPUEngine(MODEL, jengine.EngineConfig(**geom), params=jparams)
    t = tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom),
                            params=params_from_numpy(tree, "cpu"), device="cpu")
    return j, t


def _req(ds, prompt, max_new=10, **kw):
    return ds.InferenceRequest(
        prompt_token_ids=list(prompt),
        sampling=ds.SamplingParams(max_new_tokens=max_new, **kw),
    )


PROMPTS = [list(range(10, 30)), list(range(100, 137)), list(range(300, 307))]


@pytest.mark.parametrize("multi_step", [False, True])
def test_generate_greedy_streams_identical(weights, multi_step):
    j, t = _pair(weights)
    jr = j.generate([_req(jds, p) for p in PROMPTS], use_multi_step=multi_step)
    tr = t.generate([_req(tds, p) for p in PROMPTS], use_multi_step=multi_step)
    assert [r.token_ids for r in tr] == [r.token_ids for r in jr]
    assert [r.finish_reason for r in tr] == [r.finish_reason for r in jr]
    assert all(len(r.token_ids) == 10 for r in tr)


def _ragged_script(eng, ds):
    """Decode rows + two admissions (one longer than a chunk) co-dispatched
    in ragged rounds under changing per-round chunk caps, then decode_multi
    to the end."""
    first = eng.submit(_req(ds, PROMPTS[0], max_new=14))
    adms = [eng.submit_chunked_start(_req(ds, list(range(40, 110)), max_new=9)),
            eng.submit_chunked_start(_req(ds, PROMPTS[2], max_new=12))]
    rnd = 0
    while not all(a.done for a in adms):
        caps = ({adms[0].slot: 20, adms[1].slot: 0} if rnd % 3 == 0
                else {adms[0].slot: 7} if rnd % 3 == 1 else None)
        eng.ragged_round(adms, caps)
        rnd += 1
    while any(s is not None and s.finish_reason is None for s in eng.slots):
        eng.decode_multi(4)
    slots = [first] + [a.slot for a in adms]
    return [eng.finish_slot(sl).token_ids for sl in slots], rnd


def test_ragged_rounds_with_chunk_caps_identical(weights):
    j, t = _pair(weights)
    jout, jrounds = _ragged_script(j, jds)
    tout, trounds = _ragged_script(t, tds)
    assert tout == jout and trounds == jrounds
    assert [len(x) for x in tout] == [14, 9, 12]
    assert t.stats["ragged_rounds"] == j.stats["ragged_rounds"] >= 3


def test_prefix_cache_hit_identical(weights):
    j, t = _pair(weights)
    p = list(range(40, 80))            # 40 tokens → 2 full cacheable blocks
    outs = []
    for eng, ds in ((j, jds), (t, tds)):
        r1 = eng.generate([_req(ds, p)])[0]
        r2 = eng.generate([_req(ds, p + [5, 6, 7])])[0]
        outs.append((r1.token_ids, r2.token_ids, r2.cached_tokens))
    assert outs[1] == outs[0]
    assert outs[1][2] == 32


def test_preempt_resume_continues_identically(weights):
    _, t = _pair(weights)
    want = t.generate([_req(tds, PROMPTS[1], max_new=16)])[0].token_ids
    slot = t.submit(_req(tds, PROMPTS[1], max_new=16))
    t.decode_multi(5)
    pre = t.preempt_slot(slot)
    assert t.slots[slot] is None and len(pre.generated) == 6
    slot = t.resume(pre)
    assert t.slots[slot].cached_tokens > 0 or t.manager.stats.l1_hits > 0
    while t.slots[slot].finish_reason is None:
        t.decode_multi(4)
    assert t.finish_slot(slot).token_ids == want


def test_copy_on_write_copies_every_layer(weights):
    _, t = _pair(weights)
    t.kv["k"][:, 3] = torch.randn_like(t.kv["k"][:, 3])
    t.kv["v"][:, 3] = torch.randn_like(t.kv["v"][:, 3])
    t.manager.pending.copies.append((3, 5))
    t._apply_pending()
    assert torch.equal(t.kv["k"][:, 5], t.kv["k"][:, 3])
    assert torch.equal(t.kv["v"][:, 5], t.kv["v"][:, 3])
    assert t.manager.pending.empty


def test_failed_round_leaves_engine_unusable(weights, monkeypatch):
    _, t = _pair(weights)
    slot = t.submit(_req(tds, PROMPTS[0]))
    real = tllama.forward_chunk

    def half_then_fail(*a, **kw):
        real(*a, **kw)                 # the pools ARE written in place ...
        raise RuntimeError("device fault")   # ... then the round dies

    monkeypatch.setattr(tllama, "forward_chunk", half_then_fail)
    with pytest.raises(RuntimeError, match="device fault"):
        t.ragged_round()
    monkeypatch.setattr(tllama, "forward_chunk", real)
    with pytest.raises(tengine.EngineStateLost):
        t.decode_multi(2)
    with pytest.raises(tengine.EngineStateLost):
        t.submit(_req(tds, PROMPTS[2]))
    assert t.slots[slot] is not None


def test_worker_engine_inference_matches_jax_worker(weights, monkeypatch):
    from distributed_gpu_inference_tpu.worker.engines import llm as jllm

    jparams, tree = weights

    def f32_engine(name, eng_cfg, **kw):
        eng_cfg.dtype = "float32"
        return jengine.TPUEngine(name, eng_cfg, params=jparams)

    monkeypatch.setattr(jllm, "TPUEngine", f32_engine)
    common = dict(model=MODEL, max_batch_size=4, max_seq_len=128,
                  prefill_buckets=[16, 32, 64], prefix_summary_top_n=0)
    jw = jllm.TPULLMEngine(dict(common))
    tw = TorchLLMEngine(dict(common, dtype="float32", device="cpu",
                             params=params_from_numpy(tree, "cpu")))
    prompts = ["hello world, this is a test", "the quick brown fox " * 3,
               "a", "paged attention over ragged rounds"]
    results = {}
    try:
        for name, w in (("jax", jw), ("torch", tw)):
            w.load_model()
            out = [None] * len(prompts)

            def call(i, w=w, out=out):
                out[i] = w.inference({"prompt": prompts[i], "max_new_tokens": 12,
                                      "ignore_eos": True})

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
            results[name] = out
    finally:
        jw.unload()
        tw.unload()
    for jp, tp in zip(results["jax"], results["torch"]):
        assert tp["text"] == jp["text"]
        assert tp["usage"] == jp["usage"]
        assert tp["finish_reason"] == jp["finish_reason"]
    assert all(p["usage"]["completion_tokens"] == 12 for p in results["torch"])


def test_checkpoint_wire_identical_to_jax():
    kw = dict(prompt_len=3, generated=[9, 8], slot_key=(1, 2**32 - 1),
              start_time=10.5, first_token_time=11.0, cached_tokens=16,
              preempt_count=2)
    sampling = dict(max_new_tokens=20, temperature=0.7, top_k=5, seed=42,
                    stop_token_ids=(1,))
    jreq = jds.InferenceRequest(request_id="r", prompt_token_ids=[1, 2, 3],
                                sampling=jds.SamplingParams(**sampling),
                                priority=3, deadline_s=2.0, arrival_time=100.0)
    treq = tds.InferenceRequest(request_id="r", prompt_token_ids=[1, 2, 3],
                                sampling=tds.SamplingParams(**sampling),
                                priority=3, deadline_s=2.0, arrival_time=100.0)
    jwire = jengine.PreemptedSequence(request=jreq, **kw).to_wire()
    twire = tengine.PreemptedSequence(request=treq, **kw).to_wire()
    assert twire == jwire
    back = tengine.PreemptedSequence.from_wire(jwire)
    assert back.generated == [9, 8] and back.slot_key == (1, 2**32 - 1)
    assert back.request.sampling == treq.sampling
