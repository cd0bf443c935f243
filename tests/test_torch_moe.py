"""The port's Mixtral MoE (``models/llama.py`` ``_moe_mlp``) against the JAX
package on ``mixtral-tiny`` (E = 4, top-2), weights drawn once by JAX from a
seed and carried over with ``models/convert.py``; inputs from numpy seeds.

- ``_moe_mlp`` on layer 0 against JAX ``_moe_mlp``: f32 within atol and rtol
  2e-5; int8 and fp8 experts with the same codes within f32 rounding (atol
  and rtol 1e-5: JAX rounds ``code * scale`` before its product, the port
  scales the f32 sum); bf16 within atol 2^-5 and rtol 2^-6 (one or two
  bf16 ulps of outputs of order one);
- the twins of ``tests/test_model_moe.py``: the float64 per-token oracle
  (rtol and atol 2e-4), zero experts give zero output, the router stays
  unquantized; an exact router tie resolves as ``lax.top_k`` resolves it;
- ``forward_chunk`` in f32: a prefill, a chunked prefill, an S=1 decode
  step and a pad row, logits within atol 1e-4, argmax identical, pools
  within 1e-5 (the ``test_torch_model.py`` pattern);
- ``TorchEngine`` against ``TPUEngine``: identical greedy ids in f32 and
  with int8 experts, through ``generate``, ragged rounds with chunk caps
  and ``decode_multi``, and a prefix-cache hit; preempt/resume, speculative
  rounds, a KV migration between two port engines and KV handoffs across
  the packages continue to the undisturbed stream;
- a mixtral-tiny HF directory written here: both packages load it and
  serve identical ids; ``TorchLLMEngine`` through its batcher with a
  Mixtral-style tokenizer serves the text ``TPULLMEngine`` serves.

Cross-package streams run in f32: bf16 arithmetic on the CPU rounds
differently in XLA and torch."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models.configs import get_model_config as tget  # noqa: E402
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    draft_params_from_numpy,
    kv_from_numpy,
    params_from_numpy,
)
from distributed_gpu_inference_torch.ops import quantization as tq  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import kv_handoff as tkh  # noqa: E402
from distributed_gpu_inference_torch.runtime import speculative as tspec  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.ops import quantization as jq  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import kv_handoff as jkh  # noqa: E402
from distributed_gpu_inference_tpu.runtime import speculative as jspec  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402
from tests.test_torch_engine import _ragged_script  # noqa: E402
from tests.test_torch_loader import assert_same_tree, hf_tensors, write_checkpoint  # noqa: E402
from tests.test_torch_model import _rows  # noqa: E402

MODEL = "mixtral-tiny"
H = 64
GEOM = dict(max_batch_size=4, max_seq_len=128, prefill_buckets=(16, 32, 64), multi_step=8,
            dtype="float32")
PROMPTS = [list(range(10, 30)), list(range(100, 137)), list(range(300, 307))]
BF16_ATOL, BF16_RTOL = 2.0 ** -5, 2.0 ** -6


@pytest.fixture(scope="module")
def weights():
    cfg = get_model_config(MODEL)
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(7), jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


def _layer0(tree):
    return {k: ({"qw": v["qw"][0], "scale": v["scale"][0]} if tq.is_quantized(v) else v[0])
            for k, v in tree.items()}


def _x(shape=(2, 5, H), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _moe_both(dtype, mode=None, seed=3):
    """(JAX output, port output) of layer 0's MoE MLP at ``dtype``, experts
    quantized by JAX (``mode``) and carried over with the same codes."""
    jcfg = get_model_config(MODEL, dtype=dtype)
    tcfg = tget(MODEL, dtype=dtype)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.dtype(dtype))
    if mode is not None:
        jparams = jq.quantize_params(jparams, mode)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    x = _x()
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    jout = jax.jit(lambda x, lp: jllama._moe_mlp(x, lp, jcfg))(jnp.asarray(x, dtype), jlp)
    tout = tllama._moe_mlp(torch.from_numpy(x).to(tllama.torch_dtype(dtype)),
                           _layer0(tparams["layers"]), tcfg)
    return np.asarray(jout.astype(jnp.float32)), tout.float().numpy()


def test_moe_config_registered():
    cfg = tget("mixtral-8x7b")
    assert cfg.num_experts == 8 and cfg.num_experts_per_tok == 2
    assert cfg.num_params > 40e9 and cfg.param_bytes(1) == 46_702_792_704
    with pytest.raises(ValueError):
        tget(MODEL, num_experts_per_tok=9)


def test_moe_engine_generates_deterministic():
    def run():
        eng = tengine.TorchEngine(MODEL, tengine.EngineConfig(
            max_batch_size=2, max_seq_len=64, prefill_buckets=(16,), dtype="float32"),
            seed=0, device="cpu")
        return eng.generate([_req(tds, [5, 17, 3, 99, 42, 7, 256, 31])])[0].token_ids

    first = run()
    assert len(first) == 10 and run() == first


def test_moe_mlp_f32_matches_jax():
    want, got = _moe_both("float32")
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_moe_mlp_quantized_experts_match_jax(mode):
    want, got = _moe_both("float32", mode)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_moe_mlp_bf16_matches_jax():
    want, got = _moe_both("bfloat16")
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)


def test_moe_mlp_matches_per_token_oracle(weights):
    """``_moe_mlp`` == an explicit float64 per-token top-k expert loop."""
    _, tree = weights
    lp = _layer0(tree["layers"])
    x = _x((2, 3, H), seed=2)
    got = tllama._moe_mlp(torch.from_numpy(x), {k: torch.from_numpy(np.array(v))
                                                for k, v in lp.items()},
                          tget(MODEL, dtype="float32")).numpy()
    xf = x.astype(np.float64).reshape(-1, H)
    wr, wg, wu, wd = (np.asarray(lp[k], np.float64)
                      for k in ("w_router", "we_gate", "we_up", "we_down"))
    want = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        logits = xf[t] @ wr
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        top = np.argsort(probs)[::-1][:2]
        for wi, e in zip(probs[top] / probs[top].sum(), top):
            gate = xf[t] @ wg[e]
            gate = gate / (1.0 + np.exp(-gate))     # silu
            want[t] += wi * ((gate * (xf[t] @ wu[e])) @ wd[e])
    np.testing.assert_allclose(got.reshape(-1, H), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_zero_experts_give_zero_output(weights, mode):
    _, tree = weights
    params = tq.quantize_params(params_from_numpy(tree, "cpu"), mode)
    lp = _layer0(params["layers"])
    if mode is None:
        lp["we_down"] = torch.zeros_like(lp["we_down"])
    else:
        lp["we_down"] = dict(lp["we_down"], qw=torch.zeros_like(lp["we_down"]["qw"]))
    out = tllama._moe_mlp(torch.from_numpy(_x((1, 5, H), seed=4)), lp,
                          tget(MODEL, dtype="float32"))
    np.testing.assert_allclose(out.numpy(), 0.0, atol=1e-6)


def test_router_stays_unquantized_and_init_lays_out_experts():
    eng = tengine.TorchEngine(MODEL, tengine.EngineConfig(**GEOM, quantization="int8"),
                              seed=0, device="cpu")
    lp = eng.params["layers"]
    assert tq.is_quantized(lp["we_gate"]) and not tq.is_quantized(lp["w_router"])
    assert lp["we_down"]["qw"].shape == (2, 4, 128, 64)
    assert lp["we_down"]["scale"].shape == (2, 4, 1, 64)
    assert lp["w_router"].shape == (2, 64, 4) and lp["w_router"].dtype == torch.float32
    assert not {"w_gate", "w_up", "w_down"} & set(lp)
    out = eng.generate([tds.InferenceRequest(
        prompt_token_ids=PROMPTS[2], sampling=tds.SamplingParams(max_new_tokens=8))])[0]
    assert len(out.token_ids) == 8


@pytest.mark.parametrize("cols,want", [
    ((1.0, 1.0, 1.0, 0.0), [0, 1]),        # a three-way tie: the two lowest
    ((0.0, 1.0, 0.5, 1.0), [1, 3]),        # a tie for first
    ((0.5, 0.0, 1.0, 0.5), [2, 0]),        # a tie for second
])
def test_an_exact_router_tie_resolves_as_lax_top_k(cols, want):
    """Columns of the router that are exact multiples of one column give
    exactly equal logits (every product and sum is exact), so the top-k
    order among equals is the only thing left to choose."""
    rng = np.random.default_rng(5)
    x = rng.integers(-2, 3, (6, H)).astype(np.float32)
    base = rng.integers(-2, 3, (H,)).astype(np.float32) / 8
    base *= np.sign(x @ base)[0] or 1.0                  # row 0's logit >= 0
    wr = np.stack([base * c for c in cols], axis=1).astype(np.float32)
    weights, topi = tllama.route_experts(torch.from_numpy(x), torch.from_numpy(wr), 2)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(wr), axis=-1)
    _, jtop = jax.lax.top_k(probs, 2)
    assert topi[0].tolist() == want == np.asarray(jtop)[0].tolist()
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtop))
    assert torch.allclose(weights.sum(-1), torch.ones(6))
    assert (weights > 0).sum(-1).tolist() == [2] * 6


def test_forward_chunk_matches_jax(weights):
    jparams, tree = weights
    jcfg = get_model_config(MODEL, dtype="float32")
    tcfg = tget(MODEL, dtype="float32")
    tparams = params_from_numpy(tree, "cpu")
    m = 4
    jkv = jllama.init_kv_pools(jcfg, 1 + 3 * m, 16, jnp.float32)
    tkv = kv_from_numpy(jax.tree.map(np.asarray, jkv), "cpu")
    tables = np.arange(1, 1 + 3 * m, dtype=np.int32).reshape(3, m)
    tables[2] = 0                                   # inactive row: pad block
    for spans, width, last_only in (([(0, 12), (0, 16), (0, 0)], 16, False),
                                    ([(12, 16), (16, 8), (0, 0)], 16, True),
                                    ([(28, 1), (24, 1), (0, 0)], 1, True)):
        toks, pos = _rows(spans, width)
        lens = np.array([off + n for off, n in spans], np.int32)
        jout = jllama.forward_chunk(jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos), jkv,
                                    jnp.asarray(tables), jnp.asarray(lens), block_size=16,
                                    last_only=last_only)
        jkv = jout.kv
        tout = tllama.forward_chunk(tcfg, tparams, torch.from_numpy(toks),
                                    torch.from_numpy(pos), tkv, torch.from_numpy(tables),
                                    torch.from_numpy(lens), block_size=16, last_only=last_only)
        want, got = np.asarray(jout.logits), tout.logits.numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        live = pos >= 0 if not last_only else np.ones(want.shape[:2], bool)
        np.testing.assert_array_equal(got.argmax(-1)[live], want.argmax(-1)[live])
        for k in ("k", "v"):
            np.testing.assert_allclose(tkv[k].numpy(), np.asarray(jkv[k]), atol=1e-5, rtol=0)
    assert not tkv["k"][:, 0].any() and not tkv["v"][:, 0].any()


def _pair(weights, **over):
    jparams, tree = weights
    geom = {**GEOM, **over}
    j = jengine.TPUEngine(MODEL, jengine.EngineConfig(**geom), params=jparams)
    t = tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom),
                            params=params_from_numpy(tree, "cpu"), device="cpu")
    return j, t


def _req(ds, prompt, max_new=10, **kw):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=max_new, **kw))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_engines_give_identical_greedy_ids(weights, quant):
    j, t = _pair(weights, quantization=quant)
    assert tq.is_quantized(t.params["layers"]["we_up"]) == (quant is not None)
    for multi_step in (False, True):
        jr = j.generate([_req(jds, p) for p in PROMPTS], use_multi_step=multi_step)
        tr = t.generate([_req(tds, p) for p in PROMPTS], use_multi_step=multi_step)
        assert [r.token_ids for r in tr] == [r.token_ids for r in jr]
        assert all(len(r.token_ids) == 10 for r in tr)
    j2, t2 = _pair(weights, quantization=quant)
    jout, jrounds = _ragged_script(j2, jds)
    tout, trounds = _ragged_script(t2, tds)
    assert tout == jout and trounds == jrounds and [len(x) for x in tout] == [14, 9, 12]
    p = list(range(40, 80))            # 40 tokens: 2 full cacheable blocks
    hits = []
    for eng, ds in ((j, jds), (t, tds)):
        eng.generate([_req(ds, p)])
        r = eng.generate([_req(ds, p + [5, 6, 7])])[0]
        hits.append((r.token_ids, r.cached_tokens))
    assert hits[1] == hits[0] and hits[1][1] == 32


def test_preempt_resume_speculation_and_migration_continue_the_stream(weights):
    jparams, tree = weights
    _, t = _pair(weights)
    want = t.generate([_req(tds, PROMPTS[1], max_new=16)])[0].token_ids
    slot = t.submit(_req(tds, PROMPTS[1], max_new=16))
    t.decode_multi(5)
    pre = t.preempt_slot(slot)
    slot = t.resume(pre)
    while t.slots[slot].finish_reason is None:
        t.decode_multi(4)
    assert t.finish_slot(slot).token_ids == want
    # KV migration to a second port engine mid-stream
    _, dst = _pair(weights)
    slot = t.submit(_req(tds, PROMPTS[1], max_new=16))
    for _ in range(4):
        t.decode_step()
    dslot = tkh.migrate_kv_device(t, dst, slot)
    t.finish_slot(slot, cache=False)
    while dst.slots[dslot].finish_reason is None:
        dst.decode_step()
    assert list(dst.finish_slot(dslot).token_ids) == list(want)
    # speculative rounds (a JAX draft head carried over): greedy streams
    # equal the engine without speculation
    dp = jspec.init_draft_params(get_model_config(MODEL), jax.random.PRNGKey(8),
                                 dtype=jnp.float32)
    spec = tspec.SpecDecodeConfig(
        draft_params=draft_params_from_numpy(jax.tree.map(np.asarray, dp), "cpu"),
        num_draft_tokens=3)
    s = tengine.TorchEngine(MODEL, tengine.EngineConfig(**GEOM, speculative=spec),
                            params=params_from_numpy(tree, "cpu"), device="cpu")
    plain = [r.token_ids for r in t.generate([_req(tds, p) for p in PROMPTS],
                                             use_multi_step=True)]
    got = [r.token_ids for r in s.generate([_req(tds, p) for p in PROMPTS],
                                           use_multi_step=True)]
    assert got == plain and s.stats["spec_steps"] > 0


@pytest.mark.parametrize("k", [0, 4])
def test_kv_handoffs_across_packages_continue_the_stream(weights, k):
    """A JAX export adopted by the port, and a port export adopted by JAX,
    after k decode steps, continue to the uninterrupted JAX stream."""
    j, t = _pair(weights)
    want = list(j.generate([_req(jds, PROMPTS[1], 12)])[0].token_ids)
    for src, dst, skh, dkh, ds in ((j, t, jkh, tkh, jds), (t, j, tkh, jkh, tds)):
        slot = src.submit(_req(ds, PROMPTS[1], 12))
        for _ in range(k):
            src.decode_step()
        handoff = skh.export_slot_kv(src, slot)
        src.finish_slot(slot, cache=False)
        raw = (jkh.serialize_handoff(handoff, compress=False) if skh is jkh
               else tkh.serialize_handoff(handoff))
        dst.manager.clear_cached()
        dslot = dkh.adopt_kv(dst, dkh.deserialize_handoff(raw))
        while dst.slots[dslot].finish_reason is None:
            dst.decode_step()
        assert list(dst.finish_slot(dslot).token_ids) == want


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixtral")
    d = write_checkpoint(root / "ckpt", hf_tensors(tget(MODEL), seed=13), shards=2)
    tok = root / "tok"
    tok.mkdir()
    chip_smoke.write_mixtral_tokenizer(tok, open(chip_smoke.__file__.rsplit("/", 1)[0]
                                                 + "/README.md", encoding="utf-8").read(),
                                       n_merges=120, vocab_size=512)
    return str(d), str(tok)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_an_hf_directory_serves_identical_ids(checkpoint, quant):
    ckpt, _ = checkpoint
    geom = dict(GEOM, quantization=quant)
    j = jengine.TPUEngine(MODEL, jengine.EngineConfig(**geom), checkpoint_path=ckpt)
    t = tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom), checkpoint_path=ckpt,
                            device="cpu")
    assert_same_tree(j.params, t.params)
    jr = j.generate([_req(jds, p, 12) for p in PROMPTS], use_multi_step=True)
    tr = t.generate([_req(tds, p, 12) for p in PROMPTS], use_multi_step=True)
    assert [r.token_ids for r in tr] == [r.token_ids for r in jr]


def test_llm_engines_serve_equal_text_through_the_batcher(checkpoint, monkeypatch):
    from distributed_gpu_inference_tpu.worker.engines import llm as jllm

    ckpt, tok = checkpoint
    real = jllm.TPUEngine

    def f32_engine(name, eng_cfg, **kw):
        eng_cfg.dtype = "float32"          # the JAX worker has no dtype key
        return real(name, eng_cfg, **kw)

    monkeypatch.setattr(jllm, "TPUEngine", f32_engine)
    common = dict(model=MODEL, max_batch_size=4, max_seq_len=128,
                  prefill_buckets=[16, 32, 64], prefix_summary_top_n=0,
                  checkpoint_path=ckpt, tokenizer_id=tok, quantization="int8")
    jw = jllm.TPULLMEngine(dict(common))
    tw = TorchLLMEngine(dict(common, dtype="float32", device="cpu"))
    prompts = ["hello world, this is a test", "  Grüße 東京 😀 ", "a",
               "the quick brown fox " * 3]
    results = {}
    try:
        for name, w in (("jax", jw), ("torch", tw)):
            w.load_model()
            out = [None] * len(prompts)

            def call(i, w=w, out=out):
                out[i] = w.inference({"prompt": prompts[i], "max_new_tokens": 12,
                                      "ignore_eos": True})

            threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
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
        assert (tp["text"], tp["usage"], tp["finish_reason"]) == (
            jp["text"], jp["usage"], jp["finish_reason"])
    assert all(p["usage"]["completion_tokens"] == 12 for p in results["torch"])
