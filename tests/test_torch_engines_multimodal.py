"""The port's non-LLM engines (embedding, vision, whisper, image_gen)
against the JAX engines on the CPU with the same weights: each JAX engine
loads its own random init, and the port engine gets that tree through its
port-only ``params`` (and ``vision``'s ``vit_params``) keys. Mirrors
``tests/test_engines_multimodal.py``: tasks, ``pixels``, rejects, the WAV
round trip, the CTC collapse, PNG validity; plus the registry and the
worker.

What is held, and how closely:
- vision and whisper: the greedy ids (every id the tokenizer is asked to
  decode) identical to the JAX engine's, and the payloads' usage;
- image_gen, given JAX's ``jax.random.normal`` noise: the PNGs decoded by
  Pillow within PIXEL_TOL of JAX's pixels (the sampler's first step has a
  gain of ~470 on the noise prediction, which moves a few pixels of 255 by
  one step), PNG validity, seeding;
- embedding: both engines pass ``kv_lens`` of zeros, so attention sees
  nothing and a text embeds as its bag of tokens (a reference fault the
  port mirrors, module docstring of the port's engine). The port in f32
  is held to JAX's own functions in f32 (EMB_ATOL), and in bf16 to the
  JAX engine's vectors (EMB_BF16_ATOL); rows of one token and of
  ``max_seq_len`` tokens, and a row alone against its row in a batch."""

import base64
import io
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.utils.png import decode_png, encode_png  # noqa: E402
from distributed_gpu_inference_torch.worker import engines as tengines  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.base import EngineLoadError  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.embedding import (  # noqa: E402
    EmbeddingEngine,
)
from distributed_gpu_inference_torch.worker.engines.image_gen import ImageGenEngine  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.vision import VisionEngine  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.whisper import WhisperEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import embedding as jemb  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import image_gen as jimg  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import vision as jvis  # noqa: E402
from distributed_gpu_inference_tpu.worker.engines import whisper as jwh  # noqa: E402

EMB_ATOL = 1e-5          # unit vectors, f32 on both sides
EMB_BF16_ATOL = 2e-2     # bf16: XLA and torch round the CPU's bf16 products apart
PIXEL_TOL = 1            # of 255, on a few pixels


def _port_tree(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


class IdLog:
    """Wraps a tokenizer's ``decode`` to record the ids it is given."""

    def __init__(self, tok):
        self.ids, real = [], tok.decode

        def decode(ids):
            self.ids.append(list(ids))
            return real(ids)

        tok.decode = decode


def _png_b64(arr_u8):
    buf = io.BytesIO()
    Image.fromarray(arr_u8, mode="RGB").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _wav_b64(samples, rate=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((samples * 32767).astype(np.int16).tobytes())
    return base64.b64encode(buf.getvalue()).decode()


# ---------------------------------------------------------------- image generation

@pytest.fixture(scope="module")
def images():
    j = jimg.ImageGenEngine({"model": "tiny-diffusion"})
    j.load_model()
    t = ImageGenEngine({"model": "tiny-diffusion", "device": "cpu",
                        "params": _port_tree(j._params)})
    t.load_model()
    return j, t


def _jax_noise(engine, monkeypatch):
    """The port engine's first noise := the JAX engine's draw for the seed."""
    c = engine._cfg

    def noise(n, seed):
        shape = (n, c.image_size, c.image_size, c.channels)
        return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), shape)))

    monkeypatch.setattr(engine, "initial_noise", noise)


def _pixels(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"), np.int16)


def test_image_gen_pixels_match_jax(images, monkeypatch):
    j, t = images
    _jax_noise(t, monkeypatch)
    req = {"prompt": "a red square", "num_inference_steps": 4, "seed": 42, "num_images": 2}
    jo, to = j.inference(dict(req)), t.inference(dict(req))
    for key in ("format", "width", "height", "num_inference_steps", "usage"):
        assert to[key] == jo[key], key
    for a, b in zip(to["images"], jo["images"]):
        pa, pb = _pixels(a), _pixels(b)
        assert pa.shape == (32, 32, 3)
        diff = np.abs(pa - pb)
        assert diff.max() <= PIXEL_TOL and (diff > 0).mean() < 0.01


def test_image_gen_seeded_deterministic(images):
    _, t = images
    a = t.inference({"prompt": "a red square", "num_inference_steps": 4, "seed": 42})
    b = t.inference({"prompt": "a red square", "num_inference_steps": 4, "seed": 42})
    c = t.inference({"prompt": "a red square", "num_inference_steps": 4, "seed": 43})
    assert a["images"][0] == b["images"][0] and a["images"][0] != c["images"][0]


def test_image_gen_output_is_valid_png(images):
    _, t = images
    out = t.inference({"prompt": "x", "num_inference_steps": 2, "seed": 0, "num_images": 2})
    raw = base64.b64decode(out["images"][0])
    img = Image.open(io.BytesIO(raw))
    img.load()
    assert img.size == (32, 32) and img.mode == "RGB"
    assert np.array_equal(np.asarray(img), decode_png(raw))
    assert out["format"] == "png_base64" and out["usage"]["pixels"] == 2 * 32 * 32
    assert len(out["images"]) == 2 and out["images"][0] != out["images"][1]


def test_image_gen_clamps_as_jax(images, monkeypatch):
    j, t = images
    _jax_noise(t, monkeypatch)
    req = {"prompt": "x", "num_inference_steps": 0, "seed": 3, "num_images": 9,
           "guidance_scale": 0.0}
    jo, to = j.inference(dict(req)), t.inference(dict(req))
    assert to["num_inference_steps"] == jo["num_inference_steps"] == 1
    assert len(to["images"]) == len(jo["images"]) == 4


def test_image_gen_load_errors():
    with pytest.raises(EngineLoadError):
        ImageGenEngine({"model": "nope-diffusion", "device": "cpu"}).load_model()
    for cls in (ImageGenEngine, WhisperEngine):
        with pytest.raises(EngineLoadError, match="orbax checkpoints, which are JAX-only"):
            cls({"device": "cpu", "checkpoint_path": "/x/orbax"}).load_model()


# ---------------------------------------------------------------- vision

@pytest.fixture(scope="module")
def vision():
    j = jvis.VisionEngine({"model": "llama3-tiny", "vit_model": "tiny-vit",
                           "max_new_tokens": 6})
    j.load_model()
    t = VisionEngine({"model": "llama3-tiny", "vit_model": "tiny-vit", "max_new_tokens": 6,
                      "device": "cpu", "params": _port_tree(j._llm_params),
                      "vit_params": _port_tree(j._vit_params)})
    t.load_model()
    return j, t


def _same_answer(j, t, req):
    jl, tl = IdLog(j._tokenizer), IdLog(t._tokenizer)
    jo, to = j.inference(dict(req)), t.inference(dict(req))
    assert tl.ids == jl.ids and len(tl.ids) == 1
    assert (to["text"], to["task"], to["usage"]) == (jo["text"], jo["task"], jo["usage"])
    return to


def test_vision_image_qa_matches_jax(vision):
    j, t = vision
    img = (np.random.default_rng(0).random((32, 32, 3)) * 255).astype(np.uint8)
    out = _same_answer(j, t, {"task": "image_qa", "image": _png_b64(img),
                              "question": "what color?"})
    assert out["usage"]["prompt_tokens"] > 8 and out["usage"]["completion_tokens"] <= 6
    assert t._dtype == torch.float32 and t._kv["k"].dtype == torch.float32


def test_vision_tasks_and_pixels_input(vision):
    j, t = vision
    pix = np.random.default_rng(1).random((32, 32, 3)).tolist()
    for task in ("caption", "ocr"):
        assert _same_answer(j, t, {"task": task, "pixels": pix})["task"] == task


def test_vision_resizes_arbitrary_images(vision):
    j, t = vision
    img = (np.random.default_rng(2).random((48, 20, 3)) * 255).astype(np.uint8)
    _same_answer(j, t, {"task": "caption", "image": _png_b64(img)})
    # a JPEG goes through Pillow as in JAX
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    _same_answer(j, t, {"task": "caption", "image": base64.b64encode(buf.getvalue()).decode(),
                        "max_new_tokens": 3})
    # a PNG the port wrote itself reads back as the same image
    _same_answer(j, t, {"task": "ocr",
                        "image": base64.b64encode(encode_png(img[:32, :20])).decode()})


def test_vision_without_pillow_fails_the_request_not_the_engine(vision, monkeypatch):
    import builtins

    _, t = vision
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    img = (np.random.default_rng(4).random((32, 32, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    with pytest.raises(ValueError, match="Pillow is not installed"):
        t.inference({"task": "caption", "image": base64.b64encode(buf.getvalue()).decode()})
    # a 32x32 PNG needs no Pillow
    out = t.inference({"task": "caption", "image": base64.b64encode(encode_png(img)).decode()})
    assert out["task"] == "caption"


def test_vision_deterministic_and_rejects(vision):
    _, t = vision
    img = (np.random.default_rng(3).random((32, 32, 3)) * 255).astype(np.uint8)
    req = {"task": "image_qa", "image": _png_b64(img), "question": "hm?"}
    assert t.inference(req)["text"] == t.inference(req)["text"]
    with pytest.raises(ValueError, match="unknown vision task"):
        t.inference({"task": "segment", "pixels": np.zeros((32, 32, 3)).tolist()})
    with pytest.raises(ValueError, match="provide 'image'"):
        t.inference({"task": "caption"})
    with pytest.raises(ValueError, match=r"pixels must be \[H, W, 3\]"):
        t.inference({"task": "caption", "pixels": np.zeros((32, 32)).tolist()})


def test_vision_load_errors():
    with pytest.raises(EngineLoadError, match="out_dim"):
        VisionEngine({"model": "llama3-mini", "device": "cpu"}).load_model()
    with pytest.raises(EngineLoadError, match="unknown"):
        VisionEngine({"model": "llama3-tiny", "vit_model": "huge-vit",
                      "device": "cpu"}).load_model()
    bf16 = VisionEngine({"model": "llama3-tiny", "device": "cpu", "dtype": "bfloat16"})
    bf16.load_model()
    assert bf16._kv["k"].dtype == torch.bfloat16
    assert bf16.inference({"task": "caption",
                           "pixels": np.zeros((32, 32, 3)).tolist()})["task"] == "caption"


# ---------------------------------------------------------------- whisper

@pytest.fixture(scope="module")
def asr():
    j = jwh.WhisperEngine({"model": "tiny-whisper"})
    j.load_model()
    t = WhisperEngine({"model": "tiny-whisper", "device": "cpu",
                       "params": _port_tree(j._params)})
    t.load_model()
    return j, t


def _same_transcript(j, t, req):
    jl, tl = IdLog(j._tokenizer), IdLog(t._tokenizer)
    jo, to = j.inference(dict(req)), t.inference(dict(req))
    assert tl.ids == jl.ids and len(tl.ids) == 1
    for key in ("text", "language", "duration_seconds", "transcribed_seconds", "truncated",
                "usage"):
        assert to[key] == jo[key], key
    return to, tl.ids[0]


def test_asr_wav_roundtrip_matches_jax(asr):
    j, t = asr
    tt = np.linspace(0, 1.0, 16000, dtype=np.float32)
    tone = (0.3 * np.sin(2 * np.pi * 440 * tt)).astype(np.float32)
    out, ids = _same_transcript(j, t, {"audio": _wav_b64(tone)})
    assert out["duration_seconds"] == pytest.approx(1.0, rel=0.01)
    assert len(ids) > 0


def test_asr_samples_pcm_and_truncation_match_jax(asr):
    j, t = asr
    rng = np.random.default_rng(5)
    noise = (rng.random(8000).astype(np.float32) - 0.5) * 0.1
    _same_transcript(j, t, {"samples": noise.tolist()})
    long = (rng.random(5 * 16000).astype(np.float32) - 0.5) * 0.5
    out, _ = _same_transcript(j, t, {"audio": base64.b64encode(long.tobytes()).decode(),
                                     "audio_format": "pcm_f32"})
    assert out["truncated"] and out["transcribed_seconds"] == 4.0
    a = t.inference({"samples": noise.tolist()})
    assert a["text"] == t.inference({"samples": noise.tolist()})["text"]


def test_asr_rejects_wrong_rate(asr):
    _, t = asr
    with pytest.raises(ValueError, match="Hz"):
        t.inference({"audio": _wav_b64(np.zeros(8000, np.float32), rate=8000)})
    with pytest.raises(ValueError, match="provide 'audio'"):
        t.inference({})


def test_asr_ctc_collapse_semantics():
    from distributed_gpu_inference_torch.models.asr import ctc_greedy_decode

    logits = np.full((1, 7, 10), -10.0, np.float32)
    for i, tok in enumerate([0, 5, 5, 0, 5, 7, 7]):
        logits[0, i, tok] = 10.0
    assert ctc_greedy_decode(logits) == [[5, 5, 7]]


# ---------------------------------------------------------------- embedding

def _jax_reference(cfg, params, ids, kv_lens_zero):
    """The JAX engine's function with the given ``kv_lens`` choice (zeros
    is the engine's), built from JAX's own ``forward_chunk``/``rms_norm``
    on the engine's padding."""
    lengths = np.array([len(r) for r in ids], np.int32)
    b, s = len(ids), max(8, int(lengths.max()))
    batch = np.zeros((b, s), np.int32)
    for r, seq in enumerate(ids):
        batch[r, : len(seq)] = seq
    pos = np.arange(s, dtype=np.int32)[None]
    valid = pos < lengths[:, None]
    m = (s + 15) // 16
    out = jllama.forward_chunk(
        cfg, params, batch, np.where(valid, pos, -1),
        jllama.init_kv_pools(cfg, 1 + b * m, 16),
        (1 + np.arange(b * m, dtype=np.int32)).reshape(b, m),
        np.zeros((b,), np.int32) if kv_lens_zero else lengths, block_size=16,
        last_only=False)
    hidden = jllama.rms_norm(out.hidden, params["final_norm"], cfg.rms_norm_eps,
                             cfg.norm_offset).astype(jnp.float32)
    mk = valid[..., None].astype(np.float32)
    pooled = (hidden * mk).sum(1) / np.maximum(mk.sum(1), 1.0)
    return np.asarray(pooled / jnp.maximum(jnp.linalg.norm(pooled, axis=-1, keepdims=True),
                                           1e-9))


@pytest.fixture(scope="module")
def embedders():
    j = jemb.EmbeddingEngine({"model": "llama3-tiny", "max_seq_len": 40})
    j.load_model()
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), j._params)
    t = EmbeddingEngine({"model": "llama3-tiny", "max_seq_len": 40, "device": "cpu",
                         "dtype": "float32", "params": _port_tree(f32)})
    t.load_model()
    tb = EmbeddingEngine({"model": "llama3-tiny", "max_seq_len": 40, "device": "cpu",
                          "params": _port_tree(j._params)})
    tb.load_model()
    return j, f32, t, tb


TEXTS = ["a", "the quick brown fox jumps over the lazy dog, twice over!!", "hello world"]


def test_embedding_matches_jax_functions(embedders):
    j, f32, t, tb = embedders
    from distributed_gpu_inference_tpu.models.configs import get_model_config

    out = t.inference({"texts": TEXTS})
    ids = [t.tokenizer.encode(x)[:40] for x in TEXTS]
    assert [len(r) for r in ids] == [1, 40, 11]          # one token and max_seq_len
    cfg32 = get_model_config("llama3-tiny", dtype="float32")
    want = _jax_reference(cfg32, f32, ids, kv_lens_zero=True)
    got = np.asarray(out["embeddings"], np.float32)
    np.testing.assert_allclose(got, want, atol=EMB_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    assert out["dim"] == 64 and out["usage"]["prompt_tokens"] == 52
    # bf16, the model's dtype, against the JAX engine itself
    cfg = get_model_config("llama3-tiny")
    jo = j.inference({"texts": TEXTS})
    np.testing.assert_allclose(np.asarray(jo["embeddings"]),
                               _jax_reference(cfg, j._params, ids, True), atol=1e-6)
    got16 = np.asarray(tb.inference({"texts": TEXTS})["embeddings"], np.float32)
    np.testing.assert_allclose(got16, np.asarray(jo["embeddings"]), atol=EMB_BF16_ATOL)
    assert jo["usage"] == out["usage"] and jo["dim"] == out["dim"]
    # the lengths as kv_lens (tokens attending) would be another vector
    attending = _jax_reference(cfg32, f32, ids, kv_lens_zero=False)
    assert np.abs(got - attending).max() > 100 * EMB_ATOL


def test_embedding_is_a_bag_of_tokens_as_in_the_jax_engine(embedders):
    j, _, t, tb = embedders
    texts = ["ab", "ba", "abc", "cab"]
    a, b, c = (np.asarray(e.inference({"texts": texts})["embeddings"]) for e in (j, t, tb))
    for out in (a, b, c):      # one bag summed in another order: f32 rounding
        np.testing.assert_allclose(out[0], out[1], atol=1e-6)
        np.testing.assert_allclose(out[2], out[3], atol=1e-6)
    np.testing.assert_allclose(c, a, atol=EMB_BF16_ATOL)


def test_embedding_row_alone_matches_its_batch_row(embedders):
    _, _, t, _ = embedders
    batch = np.asarray(t.inference({"texts": TEXTS})["embeddings"])
    for i, text in enumerate(TEXTS):
        alone = np.asarray(t.inference({"text": text})["embeddings"])[0]
        np.testing.assert_allclose(alone, batch[i], atol=EMB_ATOL)
    empty = t.inference({"text": ""})
    assert empty["usage"]["prompt_tokens"] == 1 and len(empty["embeddings"]) == 1


# ---------------------------------------------------------------- registry + worker

def test_registry_creates_all_five_engines():
    from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine

    for task, cls in [("llm", TorchLLMEngine), ("embedding", EmbeddingEngine),
                      ("embed", EmbeddingEngine), ("image_gen", ImageGenEngine),
                      ("txt2img", ImageGenEngine), ("vision", VisionEngine),
                      ("vlm", VisionEngine), ("whisper", WhisperEngine),
                      ("asr", WhisperEngine)]:
        assert isinstance(tengines.create_engine(task, {}), cls), task
    assert set(tengines.ENGINE_REGISTRY) == {"llm", "embedding", "image_gen", "vision",
                                             "whisper"}
    with pytest.raises(KeyError, match="no engine for task type 'tts'"):
        tengines.create_engine("tts", {})


def test_worker_advertises_and_serves_the_four_engines(monkeypatch):
    from distributed_gpu_inference_torch.utils.config import EngineModelConfig, WorkerConfig
    from distributed_gpu_inference_torch.utils.data_structures import TpuTopology
    from distributed_gpu_inference_torch.worker.main import Worker

    models = {"embedding": "llama3-tiny", "vision": "llama3-tiny",
              "whisper": "tiny-whisper", "image_gen": "tiny-diffusion"}
    cfg = WorkerConfig(task_types=list(models),
                       engines={k: EngineModelConfig(model=m, dtype="float32")
                                for k, m in models.items()})
    for task in models:
        cls = tengines.get_engine_class(task)
        monkeypatch.setitem(tengines._OVERRIDES, task,
                            lambda c, cls=cls: cls(dict(c, device="cpu")))
    w = Worker(cfg, topology=TpuTopology(chip_type="cpu", num_chips=1))
    w.load_engines()
    assert sorted(w.config.task_types) == sorted(models)
    assert {type(e) for e in w.engines.values()} == {EmbeddingEngine, VisionEngine,
                                                     WhisperEngine, ImageGenEngine}
    px = np.zeros((32, 32, 3)).tolist()
    assert w.engines["vision"].inference({"task": "caption", "pixels": px,
                                          "max_new_tokens": 2})["task"] == "caption"
    assert w.engines["embedding"].inference({"text": "hi"})["dim"] == 64
    assert "text" in w.engines["whisper"].inference({"samples": [0.0] * 1600})
    assert len(w.engines["image_gen"].inference({"prompt": "x", "num_inference_steps": 1,
                                                 "seed": 0})["images"]) == 1
    # on a machine without CUDA the default device drops the type
    cfg2 = WorkerConfig(task_types=["whisper", "image_gen"],
                        engines={k: EngineModelConfig(model=models[k])
                                 for k in ("whisper", "image_gen")})
    monkeypatch.delitem(tengines._OVERRIDES, "whisper")
    monkeypatch.delitem(tengines._OVERRIDES, "image_gen")
    if not torch.cuda.is_available():
        w2 = Worker(cfg2, topology=TpuTopology(chip_type="cpu", num_chips=1))
        with pytest.raises(EngineLoadError, match="no engine loaded"):
            w2.load_engines()
