"""Serving from local files in the PyTorch port against the JAX package: one
``llama3-tiny`` HF checkpoint and one Llama 3-style tokenizer directory,
written from numpy seeds in a temp directory, go to both packages.

- ``TPUEngine(checkpoint_path=...)`` and ``TorchEngine(checkpoint_path=...)``
  load bit-identical trees and give identical greedy ids from the bf16
  checkpoint, and with int8 weights and int8 pools;
- ``TPULLMEngine`` (``AutoTokenizer`` for ``tokenizer_id``) and the port's
  ``TorchLLMEngine`` (``utils/hf_tokenizer.py``) given the same
  ``checkpoint_path`` and ``tokenizer_id`` give equal ``inference`` text and
  equal stream events (text chunks, ids, offsets, stops), with tokens that
  split multi-byte characters; chat messages go through the directory's
  template, the eos comes from ``tokenizer_config.json``, and a long prompt
  keeps its tail in ids;
- the port's ``Worker`` loads an engine whose config names both keys.

The engines compute in f32, as every cross-package stream test of the port
does: the bf16 weights cast to f32 exactly, but bf16 arithmetic on the CPU
rounds differently in XLA and in torch (greedy streams of this checkpoint
part after about ten tokens), so only the loaded bf16 trees are held bit
for bit in bf16. On the card, ``chip_smoke.py`` phase 17 serves in bf16."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("safetensors")
pytest.importorskip("transformers")

from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.utils.config import EngineModelConfig, WorkerConfig  # noqa: E402
from distributed_gpu_inference_torch.utils.data_structures import TpuTopology  # noqa: E402
from distributed_gpu_inference_torch.utils.hf_tokenizer import HFTokenizer  # noqa: E402
from distributed_gpu_inference_torch.worker.engines import _OVERRIDES, register_engine  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.base import GenerationConfig  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_torch.worker.main import Worker  # noqa: E402
from distributed_gpu_inference_tpu.models import loader as jloader  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config as jcfg  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import llm as jllm  # noqa: E402
from tests.test_torch_loader import assert_same_tree, hf_tensors, write_checkpoint  # noqa: E402
from tests.test_torch_tokenizer import build_llama3  # noqa: E402

MODEL = "llama3-tiny"
GEOM = dict(max_batch_size=4, max_seq_len=128, prefill_buckets=(16, 32, 64), multi_step=8,
            dtype="float32")
PROMPTS = [list(range(10, 30)), list(range(100, 137)), list(range(300, 307))]
TEXTS = ["Grüße aus München — 東京 😀", "hello world, this is a test",
         "the quick brown fox " * 3, "a , b . it's"]
CHAT = [{"role": "system", "content": "Be brief."},
        {"role": "user", "content": "What is 東京?"}]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from distributed_gpu_inference_torch.models.configs import get_model_config

    root = tmp_path_factory.mktemp("local")
    ckpt = write_checkpoint(root / "ckpt", hf_tensors(get_model_config(MODEL), seed=11),
                            shards=2)
    tok = build_llama3(root / "tok")
    return str(ckpt), str(tok)


def _req(ds, prompt, max_new=12):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=max_new))


def test_bf16_trees_from_one_checkpoint_are_bit_identical(files):
    ckpt, _ = files
    geom = dict(GEOM, dtype="bfloat16")
    j = jengine.TPUEngine(MODEL, jengine.EngineConfig(**geom), checkpoint_path=ckpt)
    t = tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom), checkpoint_path=ckpt,
                            device="cpu")
    assert t.params["layers"]["wq"].dtype == torch.bfloat16
    assert_same_tree(j.params, t.params)


@pytest.mark.parametrize("quant,kv", [(None, None), ("int8", "int8")], ids=["bf16", "int8"])
def test_engines_from_one_checkpoint_give_identical_greedy_ids(files, quant, kv):
    ckpt, _ = files
    geom = dict(GEOM, quantization=quant, kv_cache_dtype=kv)
    j = jengine.TPUEngine(MODEL, jengine.EngineConfig(**geom), checkpoint_path=ckpt)
    t = tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom), checkpoint_path=ckpt,
                            device="cpu")
    assert_same_tree(j.params, t.params)
    jr = j.generate([_req(jds, p) for p in PROMPTS], use_multi_step=True)
    tr = t.generate([_req(tds, p) for p in PROMPTS], use_multi_step=True)
    assert [r.token_ids for r in tr] == [r.token_ids for r in jr]
    assert all(len(r.token_ids) == 12 for r in tr)


@pytest.fixture(scope="module")
def workers(files):
    ckpt, tok = files
    common = dict(model=MODEL, max_batch_size=4, max_seq_len=128,
                  prefill_buckets=[16, 32, 64], prefix_summary_top_n=0,
                  checkpoint_path=ckpt, tokenizer_id=tok)
    real = jllm.TPUEngine

    def f32_engine(name, eng_cfg, **kw):
        eng_cfg.dtype = "float32"          # the JAX worker has no dtype key
        return real(name, eng_cfg, **kw)

    jw = jllm.TPULLMEngine(dict(common))
    tw = TorchLLMEngine(dict(common, device="cpu", dtype="float32"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllm, "TPUEngine", f32_engine)
        jw.load_model()
    tw.load_model()
    yield jw, tw
    jw.unload()
    tw.unload()


def _split(chunks):
    body, final = chunks[:-1], chunks[-1]
    assert final["done"] is True
    return ([(c.get("text_delta"), c.get("token_ids"), c.get("offset")) for c in body],
            (final["finish_reason"], final["usage"]["completion_tokens"], final.get("offset")))


@pytest.mark.parametrize("case", range(len(TEXTS) + 1))
def test_llm_engines_serve_equal_text_and_streams(workers, case):
    jw, tw = workers
    assert isinstance(tw.tokenizer, HFTokenizer)
    prompt = {"messages": CHAT} if case == len(TEXTS) else {"prompt": TEXTS[case]}
    params = dict(prompt, max_new_tokens=24, ignore_eos=True)
    want, got = jw.inference(dict(params)), tw.inference(dict(params))
    assert got["text"] == want["text"]
    assert got["usage"]["completion_tokens"] == want["usage"]["completion_tokens"] == 24
    jchunks = list(jw.stream(dict(params, stream_id=f"s{case}")))
    tchunks = list(tw.stream(dict(params, stream_id=f"s{case}")))
    assert _split(tchunks) == _split(jchunks)
    text = "".join(c.get("text_delta", "") for c in tchunks[:-1])
    ids = [i for c in tchunks[:-1] for i in c.get("token_ids", [])]
    assert text == got["text"] == tw.tokenizer.decode(ids)


def test_streams_hold_back_split_characters_as_the_reference(workers):
    # the tiny vocab has single-byte tokens: a greedy run that emits part
    # of a multi-byte character holds the U+FFFD back until it completes
    jw, tw = workers
    found = 0
    for seed in range(12):
        params = {"prompt": "東京 " * (seed + 1), "max_new_tokens": 16, "ignore_eos": True}
        tchunks = list(tw.stream(dict(params)))
        assert _split(tchunks) == _split(list(jw.stream(dict(params))))
        ids = [i for c in tchunks[:-1] for i in c.get("token_ids", [])]
        found += any("�" in tw.tokenizer.decode(ids[:n]) for n in range(1, len(ids)))
    assert found


def test_stop_ids_eos_and_prompt_tail_follow_the_tokenizer_config(workers):
    jw, tw = workers
    cfg = GenerationConfig(max_new_tokens=8)
    eot = tw.tokenizer.token_to_id("<|eot_id|>")
    assert tw.tokenizer.eos_token_id == jw.tokenizer.eos_token_id == eot
    assert tw._stop_ids(cfg) == tuple(jw._stop_ids(cfg)) == (eot,)
    assert tw._to_prompt(CHAT) == jw._to_prompt(CHAT)
    long = "the quick brown fox jumps over the lazy dog " * 40
    got = tw._encode_prompt(long, cfg)
    assert got == jw._encode_prompt(long, cfg)
    full = tw.tokenizer.encode(long)
    assert len(got) == 128 - 8 - 1 < len(full) and got == full[-len(got):]
    # with the eos among the stop ids (no ignore_eos) and a stop string
    params = {"prompt": TEXTS[0], "max_new_tokens": 20, "stop": ["o"]}
    assert tw.inference(dict(params))["text"] == jw.inference(dict(params))["text"]


def test_worker_loads_an_engine_whose_config_names_both_keys(files):
    ckpt, tok = files
    register_engine("llm", lambda c: TorchLLMEngine(dict(c, device="cpu")))
    try:
        cfg = WorkerConfig()
        cfg.engines["llm"] = EngineModelConfig(
            engine="jax", model=MODEL, extra={"checkpoint_path": ckpt, "tokenizer_id": tok,
                                              "max_seq_len": 128})
        w = Worker(cfg, api=None, topology=TpuTopology(chip_type="cpu", num_chips=1))
        w.load_engines()
        llm = w.engines["llm"]
        try:
            assert isinstance(llm.tokenizer, HFTokenizer)
            assert_same_tree(jloader.load_hf_llama(ckpt, jcfg(MODEL)), llm.engine.params)
            out = llm.inference({"prompt": TEXTS[1], "max_new_tokens": 4, "ignore_eos": True})
            assert out["usage"]["completion_tokens"] == 4
        finally:
            llm.unload()
    finally:
        _OVERRIDES.pop("llm", None)


def test_a_malformed_checkpoint_is_refused_not_replaced_by_random_weights(files, tmp_path):
    from distributed_gpu_inference_torch.worker.engines.base import EngineLoadError

    _, tok = files
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "model.safetensors").write_bytes(np.uint64(1 << 40).tobytes() + b"{}")
    llm = TorchLLMEngine({"model": MODEL, "device": "cpu", "checkpoint_path": str(bad),
                          "tokenizer_id": tok})
    with pytest.raises(EngineLoadError, match="longer than the file"):
        llm.load_model()
    assert llm.engine is None
