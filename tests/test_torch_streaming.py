"""Token streaming of ``TorchLLMEngine`` (CPU, f32, ``llama3-tiny``) held to
the JAX worker engine on the same weights: the streamed ``text_delta``s,
``token_ids`` and final usage equal ``TPULLMEngine.inference`` exactly, a
stop string from the middle of the output never leaks, a cancel stops early
and frees the slot, closing ``stream_inference`` leaves the engine quiet,
and the batch and async bridges give the blocking results."""

import asyncio
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.base import LLMBaseEngine  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402

MODEL = "llama3-tiny"
COMMON = dict(model=MODEL, max_batch_size=4, max_seq_len=128,
              prefill_buckets=[16, 32, 64])
CASES = {
    "plain": {"prompt": "abcd", "max_new_tokens": 10},
    "long": {"prompt": "stream me", "max_new_tokens": 40,
             "ignore_eos": True},
    "chat": {"messages": [{"role": "user", "content": "stream me"}],
             "max_new_tokens": 12, "ignore_eos": True},
}


def _recording(worker):
    """Wrap the worker's ``serving.submit`` to keep each response's token
    ids by prompt (the result payload carries text only)."""
    seen = {}
    real = worker.serving.submit

    def submit(req, *a, **kw):
        resp = real(req, *a, **kw)
        seen[tuple(req.prompt_token_ids)] = list(resp.token_ids)
        return resp

    worker.serving.submit = submit
    return seen


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(7),
                                 jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX worker's blocking results (payload, token ids) for every case,
    and for the long case cut by a stop string from the middle of its
    output; plus its batch path on two of them."""
    from distributed_gpu_inference_tpu.worker.engines import llm as jllm

    jparams, _ = weights

    def f32_engine(name, eng_cfg, **kw):
        eng_cfg.dtype = "float32"
        return jengine.TPUEngine(name, eng_cfg, params=jparams)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllm, "TPUEngine", f32_engine)
        jw = jllm.TPULLMEngine(dict(COMMON, prefix_summary_top_n=0))
        jw.load_model()
    try:
        seen = _recording(jw)
        out = {}
        for name, params in CASES.items():
            payload = jw.inference(dict(params))
            ids = seen[tuple(jw.tokenizer.encode(jw._to_prompt(
                params.get("messages") or params["prompt"])))]
            out[name] = (payload, ids)
        text = out["long"][0]["text"]
        assert len(text) >= 6, text
        stop = text[3:5]
        out["stop"] = (jw.inference(dict(CASES["long"], stop=[stop])), None, stop)
        out["batch"] = jw.batch_inference([dict(CASES["plain"]), dict(CASES["long"])])
    finally:
        jw.unload()
    return out


@pytest.fixture(scope="module")
def port(weights):
    _, tree = weights
    tw = TorchLLMEngine(dict(COMMON, dtype="float32", device="cpu",
                             params=params_from_numpy(tree, "cpu")))
    tw.load_model()
    yield tw
    tw.unload()


def _uncached(usage):
    """Usage without ``cached_tokens``, which depends on what earlier
    requests left in the prefix cache."""
    return {k: v for k, v in usage.items() if k != "cached_tokens"}


def _split(chunks):
    body, final = chunks[:-1], chunks[-1]
    assert final["done"] is True and all("done" not in c for c in body)
    text = "".join(c.get("text_delta", "") for c in body)
    ids = [t for c in body for t in c.get("token_ids", [])]
    return text, ids, final


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_equals_jax_blocking_result(port, reference, case):
    payload, ids = reference[case]
    chunks = list(port.stream(dict(CASES[case], stream_id=f"s-{case}")))
    text, got_ids, final = _split(chunks)
    assert text == payload["text"]
    assert got_ids == ids
    assert final["usage"] == payload["usage"]
    assert final["finish_reason"] == payload["finish_reason"]
    # one event per token, stamped with contiguous offsets 1..N
    assert [c["offset"] for c in chunks[:-1]] == list(range(1, len(ids) + 1))
    assert final["offset"] == len(ids) and final["stream_id"] == f"s-{case}"
    assert all(len(c["token_ids"]) == 1 for c in chunks[:-1])
    assert port.engine.num_active == 0


def test_stream_without_a_key_carries_no_offsets(port, reference):
    chunks = list(port.stream(dict(CASES["plain"])))
    assert all("offset" not in c and "stream_id" not in c for c in chunks)
    assert _split(chunks)[0] == reference["plain"][0]["text"]


def test_stop_string_never_leaks_into_the_stream(port, reference):
    want, _, stop = reference["stop"]
    chunks = list(port.stream(dict(CASES["long"], stop=[stop])))
    text, _, final = _split(chunks)
    assert text == want["text"]
    assert stop not in text
    assert final["finish_reason"] == "stop" == want["finish_reason"]
    assert port.engine.num_active == 0


def test_cancel_mid_stream_stops_early_and_frees_the_slot(port, monkeypatch):
    # the engine waits before its first decode round while the stream
    # notices the cancel (its 50 ms poll) and stops the request, so the
    # cancel surely lands mid-generation
    release = threading.Event()
    real = port.engine.decode_multi

    def held(*a, **kw):
        release.wait(30.0)
        return real(*a, **kw)

    monkeypatch.setattr(port.engine, "decode_multi", held)
    cancel = threading.Event()
    gen = port.stream({"prompt": "abcd", "max_new_tokens": 100, "ignore_eos": True},
                      cancel=cancel)
    first = next(gen)
    assert first["token_ids"]
    cancel.set()
    timer = threading.Timer(0.5, release.set)
    timer.start()
    try:
        rest = list(gen)
    finally:
        timer.join()
    assert rest[-1]["done"] is True and rest[-1]["finish_reason"] == "abort"
    total = sum(len(c.get("token_ids", [])) for c in [first] + rest[:-1])
    assert total < 100
    assert port.engine.num_active == 0


def test_closing_stream_inference_early_leaves_the_engine_quiet(port):
    async def body():
        agen = port.stream_inference({"prompt": "abcd", "max_new_tokens": 100,
                                      "ignore_eos": True})
        got = await agen.__anext__()
        assert got["token_ids"]
        await agen.aclose()
        assert port.engine.num_active == 0

    asyncio.run(body())
    # the engine serves the next request normally
    assert port.inference({"prompt": "x", "max_new_tokens": 3})["usage"][
        "completion_tokens"] >= 1


def test_stream_inference_yields_the_stream(port, reference):
    async def body():
        return [c async for c in port.stream_inference(dict(CASES["chat"]))]

    text, _, final = _split(asyncio.run(body()))
    assert text == reference["chat"][0]["text"]
    assert _uncached(final["usage"]) == _uncached(reference["chat"][0]["usage"])


def test_stream_error_becomes_an_error_event(port):
    async def body():
        return [c async for c in port.stream_inference(
            {"prompt": "a" * 200, "max_new_tokens": 200})]

    chunks = asyncio.run(body())
    assert len(chunks) == 1 and "error" in chunks[0]
    assert port.engine.num_active == 0


def test_batch_inference_equals_jax_batch_path(port, reference):
    got = port.batch_inference([dict(CASES["plain"]), dict(CASES["long"])])
    for g, w in zip(got, reference["batch"]):
        assert g["text"] == w["text"]
        assert _uncached(g["usage"]) == _uncached(w["usage"])
        assert g["finish_reason"] == w["finish_reason"]


def test_async_and_batch_bridges_give_the_blocking_results(port, reference):
    async def body():
        one = await port.inference_async(dict(CASES["plain"]))
        many = await port.batch_inference_async([dict(CASES["plain"]),
                                                 dict(CASES["chat"])])
        return one, many

    one, many = asyncio.run(body())
    for got, case in ((one, "plain"), (many[0], "plain"), (many[1], "chat")):
        assert got["text"] == reference[case][0]["text"]
        assert _uncached(got["usage"]) == _uncached(reference[case][0]["usage"])


def test_base_engine_streams_one_final_chunk():
    class Echo(LLMBaseEngine):
        def load_model(self):
            self.loaded = True

        def inference(self, params):
            return {"text": params["prompt"].upper()}

    async def body():
        e = Echo()
        return ([c async for c in e.stream_inference({"prompt": "hi"})],
                await e.batch_inference_async([{"prompt": "a"}, {"prompt": "b"}]),
                e.batch_inference([{"prompt": "c"}]))

    chunks, many, sync = asyncio.run(body())
    assert chunks == [{"text": "HI"}]
    assert many == [{"text": "A"}, {"text": "B"}] and sync == [{"text": "C"}]
