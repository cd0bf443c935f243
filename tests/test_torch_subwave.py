"""Sub-wave admission on the legacy path (``EngineConfig.admission_subwave``
/ ``admission_interleave_steps``): ``TorchEngine`` against ``TPUEngine`` on
``llama3-tiny`` with the same weights in f32 on the CPU — the ports of
``tests/test_runtime_engine.py``'s two sub-wave tests as parity tests, a
mixed-temperature wave whose first tokens equal the wide path's, the
rollback's count of interleaved tokens, and the worker's ``serving.subwave``
/ ``serving.interleave`` reaching the engine at load but not by a remote
push. Two ``gpu`` tests run the narrow prefill and a direct-mode stream on
the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
GEOM = dict(max_batch_size=6, max_seq_len=128, prefill_buckets=(16, 32, 64),
            multi_step=8, dtype="float32")
PROMPTS = [list(range(7 + i, 27 + 2 * i)) for i in range(6)]
# buckets 16, 64, 16, chunked (> 64), 16, 64, out of slot order
MIXED = [list(range(5 + i, 5 + i + n)) for i, n in enumerate((10, 40, 14, 70, 12, 50))]


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(13),
                                 jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


def _jax(weights, **over):
    return jengine.TPUEngine(MODEL, jengine.EngineConfig(**{**GEOM, **over}),
                             params=weights[0])


def _port(weights, **over):
    return tengine.TorchEngine(MODEL, tengine.EngineConfig(**{**GEOM, **over}),
                               params=params_from_numpy(weights[1], "cpu"), device="cpu")


def _req(ds, prompt, max_new=8, **kw):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=max_new, **kw))


def _subwave_parity(weights, sw, prompts):
    """``generate`` over ``prompts`` with the whole-wave admission and with
    sub-waves of ``sw`` on the port, and with sub-waves on the JAX engine:
    the same greedy tokens and counters, and narrow prefills, as many as
    the JAX engine ran."""
    wide, sub, jsub = _port(weights), _port(weights, admission_subwave=sw), \
        _jax(weights, admission_subwave=sw)
    r_wide = wide.generate([_req(tds, p) for p in prompts], use_multi_step=True)
    r_sub = sub.generate([_req(tds, p) for p in prompts], use_multi_step=True)
    r_jax = jsub.generate([_req(jds, p) for p in prompts], use_multi_step=True)
    assert [r.token_ids for r in r_wide] == [r.token_ids for r in r_sub] \
        == [r.token_ids for r in r_jax]
    assert sub.stats["prefill_calls"] == jsub.stats["prefill_calls"] \
        > wide.stats["prefill_calls"]
    for k in ("prefill_tokens", "generated_tokens", "requests"):
        assert sub.stats[k] == wide.stats[k] == jsub.stats[k], k


@pytest.mark.parametrize("sw", [1, 2, 4])
def test_subwave_admission_matches_the_whole_wave_and_jax(weights, sw):
    _subwave_parity(weights, sw, PROMPTS)


@pytest.mark.parametrize("sw", [1, 2])
def test_a_multi_bucket_subwave_wave_matches_the_whole_wave_and_jax(weights, sw):
    """A wave across three buckets and the chunked path: each bucket group
    is cut into its own sub-waves."""
    _subwave_parity(weights, sw, MIXED)


def test_subwave_widths_are_powers_of_two_capped_at_the_slot_count(weights, monkeypatch):
    eng = _port(weights, admission_subwave=3, max_batch_size=5)
    widths = []
    real = eng._forward

    def forward(toks_pos, tables, lens, **kw):
        widths.append((toks_pos.shape[1], tables.shape[0], int((toks_pos[1] >= 0).any(1).sum())))
        return real(toks_pos, tables, lens, **kw)

    monkeypatch.setattr(eng, "_forward", forward)
    eng.submit_batch([_req(tds, p) for p in PROMPTS[:5]])
    # chunks of 3 and 2 sequences: widths 4 and 2, pad rows at position -1
    assert widths == [(4, 4, 3), (2, 2, 2)]


def test_subwave_interleave_advances_existing_slots(weights):
    cfg = dict(admission_subwave=1, admission_interleave_steps=2)
    out = {}
    for name, eng, ds in (("port", _port(weights, **cfg), tds),
                          ("jax", _jax(weights, **cfg), jds)):
        s0 = eng.submit(_req(ds, range(30, 50), max_new=24))
        before = len(eng.slots[s0].generated)
        eng.submit_batch([_req(ds, range(60 + i, 80 + i), max_new=4) for i in range(4)])
        # the earlier slot advanced during the admission (3 interleave gaps)
        advanced = len(eng.slots[s0].generated) - before
        while any(s is not None and s.finish_reason is None for s in eng.slots):
            eng.decode_multi()
        out[name] = (advanced, eng.finish_slot(s0).token_ids, dict(eng.stats))
    assert out["port"][0] == out["jax"][0] == 6
    solo = _port(weights).generate([_req(tds, range(30, 50), max_new=24)])[0]
    assert out["port"][1] == out["jax"][1] == solo.token_ids
    for k in ("prefill_calls", "prefill_tokens", "generated_tokens", "requests"):
        assert out["port"][2][k] == out["jax"][2][k], k


def test_a_mixed_temperature_wave_samples_as_the_wide_path(weights):
    def wave(ds):
        return [_req(ds, p, max_new=6, temperature=t, top_k=k, top_p=tp, seed=40 + i)
                for i, (p, t, k, tp) in enumerate(zip(
                    PROMPTS, (0.0, 0.9, 1.3, 0.0, 0.7, 1.0), (0, 5, 0, 0, 50, 3),
                    (1.0, 0.9, 0.8, 1.0, 1.0, 0.95)))]

    wide, sub = _port(weights), _port(weights, admission_subwave=2)
    jsub = _jax(weights, admission_subwave=2)
    firsts = []
    for eng, ds in ((wide, tds), (sub, tds), (jsub, jds)):
        slots = eng.submit_batch(wave(ds))
        firsts.append([eng.slots[s].generated[0] for s in slots])
        for s in slots:
            eng.finish_slot(s)
    assert firsts[0] == firsts[1] == firsts[2]
    r_wide = wide.generate(wave(tds), use_multi_step=True)
    r_sub = sub.generate(wave(tds), use_multi_step=True)
    assert [r.token_ids for r in r_wide] == [r.token_ids for r in r_sub]


def test_a_failed_subwave_rolls_back_but_keeps_interleaved_tokens(weights, monkeypatch):
    """A wave that fails after interleaved decode rounds frees every
    sequence it admitted, restores the counters, and keeps the decode
    tokens that went to the slot outside the wave — as the JAX engine
    does."""
    cfg = dict(admission_subwave=1, admission_interleave_steps=2)
    out = {}
    for name, eng, ds in (("port", _port(weights, **cfg), tds),
                          ("jax", _jax(weights, **cfg), jds)):
        s0 = eng.submit(_req(ds, range(30, 50), max_new=24))
        before = dict(eng.stats)
        real, calls = eng._prefill_subwave, [0]

        def failing(bucket, chunk, _real=real, _calls=calls):
            _calls[0] += 1
            if _calls[0] == 3:
                raise RuntimeError("third sub-wave fails")
            return _real(bucket, chunk)

        monkeypatch.setattr(eng, "_prefill_subwave", failing)
        with pytest.raises(RuntimeError, match="third sub-wave"):
            eng.submit_batch([_req(ds, range(60 + i, 80 + i), max_new=4) for i in range(4)])
        monkeypatch.undo()
        live = [i for i, s in enumerate(eng.slots) if s is not None]
        out[name] = (live, len(eng.slots[s0].generated), eng.stats["generated_tokens"]
                     - before["generated_tokens"], eng.stats["requests"] - before["requests"])
    assert out["port"] == out["jax"]
    live, n, extra, reqs = out["port"]
    assert live == [0] and extra == n - 1 == 4 and reqs == 0


# ---------------------------------------------------------------- the worker


def test_the_worker_passes_subwave_and_interleave_to_the_engine(weights):
    base = dict(model=MODEL, max_batch_size=4, max_seq_len=128, prefill_buckets=[16, 32, 64],
                prefix_summary_top_n=0, dtype="float32", device="cpu")
    outs = {}
    for sv in ({"ragged": False}, {"ragged": False, "subwave": 2, "interleave": 1}):
        w = TorchLLMEngine(dict(base, serving=sv, params=params_from_numpy(weights[1], "cpu")))
        w.load_model()
        try:
            assert w.engine.cfg.admission_subwave == sv.get("subwave", 0)
            assert w.engine.cfg.admission_interleave_steps == sv.get("interleave", 0)
            # a remote push leaves the load-time admission keys untouched
            w.apply_serving_config({"target_step_ms": 123.0, "subwave": 9, "interleave": 9,
                                    "mode": "direct"})
            assert w.engine.cfg.admission_subwave == sv.get("subwave", 0)
            assert w.engine.cfg.admission_interleave_steps == sv.get("interleave", 0)
            assert w.serving is not None
            batch = [{"prompt": "abc" * (i + 1), "max_new_tokens": 8, "ignore_eos": True}
                     for i in range(4)]
            outs[bool(sv.get("subwave"))] = [p["text"] for p in w.batch_inference(batch)]
        finally:
            w.unload()
    assert outs[True] == outs[False]


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_narrow_prefill_runs_the_kernels_on_the_card(cuda):
    """Sub-wave admission at llama3-mini on the card, over two buckets: three
    narrow forwards (widths 4, 4 and 1) launch the ragged kernel, each
    request's first-token logits agree with the whole wave's (bf16 weights: both products are cuBLAS
    matmuls; with int8 weights a narrow forward of at most 128 rows would
    run the quantized matmul's kernel where the whole wave runs its
    library route, which rounds otherwise), and the wave then decodes
    through the fused kernel."""
    from distributed_gpu_inference_torch.ops import paged_attention as pa

    geom = dict(max_batch_size=8, max_seq_len=256, prefill_buckets=(16, 32, 64),
                multi_step=4)
    seen = {}

    def traced(eng, name):
        real = eng._sample

        def sample(logits, rows, positions, mode):
            for r, i in enumerate(rows):
                # a wide forward's rows of the other bucket have length 0
                if int(positions[r]) > 0:
                    seen.setdefault(name, {})[i] = logits[r].float().cpu()
            return real(logits, rows, positions, mode)
        eng._sample = sample

    wide = tengine.TorchEngine("llama3-mini", tengine.EngineConfig(**geom), device=cuda)
    sub = tengine.TorchEngine("llama3-mini", tengine.EngineConfig(**geom, admission_subwave=4),
                              params=wide.params, device=cuda)
    traced(wide, "wide")
    traced(sub, "sub")
    # 20-62 tokens: buckets 32 (3 prompts) and 64 (5 prompts)
    prompts = [list(range(11 + 3 * i, 31 + 9 * i)) for i in range(8)]
    wide.submit_batch([_req(tds, p) for p in prompts])
    pa.reset_launch_counts()
    sub.submit_batch([_req(tds, p) for p in prompts])
    torch.cuda.synchronize()
    assert pa.launch_counts()["ragged_paged_attention"] > 0
    assert sub.stats["prefill_calls"] == 3 and wide.stats["prefill_calls"] == 2
    assert set(seen["sub"]) == set(seen["wide"]) == set(range(8))
    for slot, want in seen["wide"].items():
        got = seen["sub"][slot]
        assert (got - want).abs().max() < 0.02, slot
        assert int(got.argmax()) == int(want.argmax()), slot
    pa.reset_launch_counts()
    sub.decode_multi(4)
    torch.cuda.synchronize()
    assert pa.launch_counts()["paged_decode_attention_fused"] > 0


@pytest.mark.gpu
def test_a_direct_stream_runs_on_the_card(cuda):
    from distributed_gpu_inference_torch.ops import paged_attention as pa

    w = TorchLLMEngine({"model": "llama3-mini", "max_batch_size": 4, "max_seq_len": 256,
                        "prefix_summary_top_n": 0, "serving": {"mode": "direct"}})
    w.load_model()
    try:
        pa.reset_launch_counts()
        chunks = list(w.stream({"prompt": "a direct stream", "max_new_tokens": 12,
                                "ignore_eos": True, "stream_id": "s"}))
        torch.cuda.synchronize()
        counts = pa.launch_counts()
        ids = [t for c in chunks[:-1] for t in c["token_ids"]]
        assert len(ids) == 12 and chunks[-1]["done"]
        assert counts["paged_decode_attention_fused"] >= 11
        assert counts["ragged_paged_attention"] >= 1
        assert w.engine.num_active == 0
    finally:
        w.unload()
