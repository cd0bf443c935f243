"""The encoder models of the port against the JAX package on the CPU, the
same weights (JAX's random init carried across with
``models.convert.params_from_numpy``) and inputs from numpy seeds:

- ``encoder_common`` (LayerNorm with the population variance, tanh GELU,
  optional biases, patchify/unpatchify round trip);
- ``vit.encode_image``, with and without the HF import's bias keys;
- ``asr.log_mel`` (host numpy, bit for bit), ``asr.encode`` and the CTC
  collapse;
- ``diffusion.denoise``, the DDIM schedule (its timesteps bit for bit,
  its f32 alphas to an ulp) and a 3-step
  ``ddim_sample`` given JAX's own ``jax.random.normal`` noise;
- ``llama.forward_hidden_chunk`` (a pre-embedded prefix, pad positions,
  then a decode step) and its int8-pool refusal.

Tolerance: f32 on both sides in another summation order, ENC_ATOL
absolute on outputs of order 1. The sampler's first step divides the
guided noise prediction's error (guidance 3) by sqrt(alphas_bar[999]) =
6.4e-3, a gain of ~470, so an error of ~1e-6 there reaches ~5e-4 in the
image: every pixel within IMG_ATOL, their mean within IMG_MEAN_ATOL."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models import asr as tasr  # noqa: E402
from distributed_gpu_inference_torch.models import diffusion as tdiff  # noqa: E402
from distributed_gpu_inference_torch.models import encoder_common as tenc  # noqa: E402
from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models import vit as tvit  # noqa: E402
from distributed_gpu_inference_torch.models.configs import (  # noqa: E402
    get_model_config as t_config,
)
from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_tpu.models import asr as jasr  # noqa: E402
from distributed_gpu_inference_tpu.models import diffusion as jdiff  # noqa: E402
from distributed_gpu_inference_tpu.models import encoder_common as jenc  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models import vit as jvit  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402

ENC_ATOL = 2e-5
IMG_ATOL, IMG_MEAN_ATOL = 2e-3, 2e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return params_from_numpy(_np_tree(tree), "cpu")


def _with_biases(params, key):
    """The bias keys an HF ViT import carries, on a JAX ViT tree."""
    L, h = params["layers"]["wqkv"].shape[0], params["out_norm"].shape[0]
    ks = jax.random.split(key, 8)
    out = dict(params, patch_bias=jax.random.normal(ks[0], (h,)),
               out_norm_b=jax.random.normal(ks[1], (h,)))
    out["layers"] = dict(params["layers"],
                         norm1_b=jax.random.normal(ks[2], (L, h)),
                         norm2_b=jax.random.normal(ks[3], (L, h)),
                         bqkv=jax.random.normal(ks[4], (L, 3 * h)),
                         bo=jax.random.normal(ks[5], (L, h)),
                         b1=jax.random.normal(ks[6], (L, 4 * h)),
                         b2=jax.random.normal(ks[7], (L, h)))
    return out


def test_encoder_common_matches_jax():
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((2, 5, 12)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal(12).astype(np.float32), rng.standard_normal(12).astype(np.float32)
    np.testing.assert_allclose(
        tenc.layer_norm(torch.from_numpy(v), torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        np.asarray(jenc.layer_norm(v, w, b)), atol=ENC_ATOL)
    layers = jenc.init_encoder_layers(jax.random.PRNGKey(1), 2, 12)
    lp = _np_tree(jax.tree.map(lambda a: a[0], layers))
    lp["b1"] = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    got = tenc.encoder_block(torch.from_numpy(x), params_from_numpy(lp, "cpu"), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jenc.encoder_block(x, lp, 3)),
                               atol=ENC_ATOL)
    got = tenc.run_encoder(torch.from_numpy(x), _port(layers), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jenc.run_encoder(x, layers, 3)),
                               atol=ENC_ATOL)
    img = rng.random((2, 8, 8, 3)).astype(np.float32)
    p = tenc.patchify(torch.from_numpy(img), 4)
    assert np.array_equal(p.numpy(), np.asarray(jenc.patchify(img, 4)))
    assert np.array_equal(tenc.unpatchify(p, 8, 4, 3).numpy(), img)


@pytest.mark.parametrize("biases", [False, True], ids=["first-party", "hf-biases"])
def test_encode_image_matches_jax(biases):
    cfg = jvit.get_vit_config("tiny-vit")
    jp = jvit.init_params(cfg, jax.random.PRNGKey(7))
    if biases:
        jp = _with_biases(jp, jax.random.PRNGKey(8))
    img = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jvit.encode_image(cfg, p, x))(jp, img))
    got = tvit.encode_image(tvit.get_vit_config("tiny-vit"), _port(jp), torch.from_numpy(img))
    assert got.shape == (2, cfg.num_prefix, cfg.out_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=ENC_ATOL)


def test_configs_and_registries_match_jax():
    for t, j in ((tvit.VIT_REGISTRY, jvit.VIT_REGISTRY), (tasr.ASR_REGISTRY, jasr.ASR_REGISTRY),
                 (tdiff.DIFFUSION_REGISTRY, jdiff.DIFFUSION_REGISTRY)):
        assert {k: dataclasses.asdict(v) for k, v in t.items()} == \
            {k: dataclasses.asdict(v) for k, v in j.items()}
    for get in (tvit.get_vit_config, tasr.get_asr_config, tdiff.get_diffusion_config):
        with pytest.raises(KeyError, match="unknown"):
            get("nope")
    # the random inits' layout (the values are torch draws, not threefry)
    g = torch.Generator().manual_seed(0)
    for t_mod, j_mod, cfg in ((tvit, jvit, jvit.get_vit_config("tiny-vit")),
                              (tasr, jasr, jasr.get_asr_config("tiny-whisper")),
                              (tdiff, jdiff, jdiff.get_diffusion_config("tiny-diffusion"))):
        shapes = jax.tree.map(lambda a: tuple(a.shape), j_mod.init_params(cfg, jax.random.PRNGKey(0)))
        got = t_mod.init_params(cfg, g)
        assert jax.tree.map(lambda a: tuple(a.shape), got) == shapes


def test_asr_matches_jax():
    cfg = jasr.get_asr_config("tiny-whisper")
    tcfg = tasr.get_asr_config("tiny-whisper")
    audio = (np.random.default_rng(2).random((2, cfg.max_samples)) - 0.5).astype(np.float32)
    mel = tasr.log_mel(tcfg, audio)
    assert np.array_equal(mel, jasr.log_mel(cfg, audio))
    jp = jasr.init_params(cfg, jax.random.PRNGKey(3))
    want = np.asarray(jax.jit(lambda p, m: jasr.encode(cfg, p, m))(jp, mel))
    got = tasr.encode(tcfg, _port(jp), torch.from_numpy(mel)).numpy()
    assert got.shape == (2, cfg.enc_frames, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=ENC_ATOL)
    assert tasr.ctc_greedy_decode(got) == jasr.ctc_greedy_decode(want)
    logits = np.full((1, 7, 10), -10.0, np.float32)
    for i, t in enumerate([0, 5, 5, 0, 5, 7, 7]):
        logits[0, i, t] = 10.0
    assert tasr.ctc_greedy_decode(logits) == jasr.ctc_greedy_decode(logits) == [[5, 5, 7]]


@pytest.fixture(scope="module")
def dit():
    cfg = jdiff.get_diffusion_config("tiny-diffusion")
    jp = jdiff.init_params(cfg, jax.random.PRNGKey(4))
    return cfg, jp, _port(jp)


def test_denoise_and_schedule_match_jax(dit):
    cfg, jp, tp = dit
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    toks = np.zeros((2, cfg.max_text_len), np.int32)
    toks[0, :5] = [5, 9, 11, 3, 100]
    cond = jdiff.encode_text(cfg, jp, toks)
    tcond = tdiff.encode_text(cfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tcond.numpy(), np.asarray(cond), atol=ENC_ATOL)
    want = np.asarray(jax.jit(lambda p, a, b, c: jdiff.denoise(cfg, p, a, b, c))(jp, x, t, cond))
    got = tdiff.denoise(cfg, tp, torch.from_numpy(x), torch.from_numpy(t), tcond).numpy()
    np.testing.assert_allclose(got, want, atol=ENC_ATOL)
    emb = tdiff._timestep_embedding(torch.from_numpy(t), 16).numpy()
    np.testing.assert_allclose(emb, np.asarray(jdiff._timestep_embedding(t, 16)), atol=1e-6)
    for steps in (1, 3, 7, 20, 50):
        alphas_bar, step_ts = tdiff.schedule(cfg, steps)
        assert np.array_equal(
            step_ts.numpy(),
            np.asarray(jnp.linspace(cfg.timesteps - 1, 0, steps).astype(jnp.int32)))
    betas = np.asarray(jnp.linspace(1e-4, 0.02, cfg.timesteps))
    # XLA folds the constant linspace with its own rounding: 1-ulp apart
    np.testing.assert_allclose(tdiff._linspace_f32(1e-4, 0.02, cfg.timesteps).numpy(), betas,
                               rtol=1e-6)
    np.testing.assert_allclose(alphas_bar.numpy(), np.asarray(jnp.cumprod(1.0 - betas)),
                               rtol=1e-6)


def test_ddim_sample_matches_jax_given_its_noise(dit):
    cfg, jp, tp = dit
    toks = np.zeros((2, cfg.max_text_len), np.int32)
    toks[0, :3] = [40, 41, 42]
    key = jax.random.PRNGKey(9)
    want = np.asarray(jdiff.sample_jit(cfg, jp, jnp.asarray(toks), key, num_steps=3,
                                       guidance_scale=3.0))
    noise = np.asarray(jax.random.normal(key, (2, cfg.image_size, cfg.image_size,
                                               cfg.channels)))
    got = tdiff.ddim_sample(cfg, tp, torch.from_numpy(toks), num_steps=3,
                            guidance_scale=3.0, noise=torch.from_numpy(noise.copy())).numpy()
    assert got.shape == want.shape and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=IMG_ATOL)
    assert np.abs(got - want).mean() < IMG_MEAN_ATOL
    # the generator draws its own noise; the same seed repeats
    a = tdiff.ddim_sample(cfg, tp, torch.from_numpy(toks), torch.Generator().manual_seed(1),
                          num_steps=2)
    b = tdiff.ddim_sample(cfg, tp, torch.from_numpy(toks), torch.Generator().manual_seed(1),
                          num_steps=2)
    assert torch.equal(a, b)


# ---------------------------------------------------------------- forward_hidden_chunk

def test_forward_hidden_chunk_matches_jax():
    cfg = get_model_config("llama3-tiny", dtype="float32")
    tcfg = t_config("llama3-tiny", dtype="float32")
    jp = jllama.init_params(cfg, jax.random.PRNGKey(6), jnp.float32)
    tp = _port(jp)
    rng = np.random.default_rng(7)
    n_prefix, text, pad = 5, 6, 4
    s = n_prefix + text + pad
    hidden = rng.standard_normal((1, s, cfg.hidden_size)).astype(np.float32)
    positions = np.full((1, s), -1, np.int32)
    positions[0, : n_prefix + text] = np.arange(n_prefix + text)
    table = np.arange(1, 4, dtype=np.int32)[None]
    seq = np.array([n_prefix + text], np.int32)

    jkv = jllama.init_kv_pools(cfg, 5, 16, jnp.float32)
    jh, jkv = jax.jit(lambda h, kv: jllama.forward_hidden_chunk(
        cfg, jp, h, positions, kv, table, seq, block_size=16))(hidden, jkv)
    tkv = tllama.init_kv_pools(tcfg, 5, 16, torch.float32, "cpu")
    th, tkv = tllama.forward_hidden_chunk(
        tcfg, tp, torch.from_numpy(hidden), torch.from_numpy(positions), tkv,
        torch.from_numpy(table), torch.from_numpy(seq), block_size=16)
    valid = positions[0] >= 0
    np.testing.assert_allclose(th.numpy()[0, valid], np.asarray(jh)[0, valid], atol=ENC_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]), atol=ENC_ATOL)
    # the pad positions wrote nothing: slots n_prefix+text.. stay zero
    assert not tkv["k"][:, 1, :, n_prefix + text:].any()
    # then one step of one token (the fused decode path)
    step = rng.standard_normal((1, 1, cfg.hidden_size)).astype(np.float32)
    pos1, len1 = seq[:, None].copy(), seq + 1
    jh1, _ = jllama.forward_hidden_chunk(cfg, jp, step, pos1, jkv, table, len1, block_size=16)
    th1, _ = tllama.forward_hidden_chunk(tcfg, tp, torch.from_numpy(step), torch.from_numpy(pos1),
                                         tkv, torch.from_numpy(table), torch.from_numpy(len1),
                                         block_size=16)
    np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), atol=ENC_ATOL)
    # a stage that owns the second layer: its params and pools only
    cfg1 = dataclasses.replace(cfg, num_layers=1)
    jp1 = dict(jp, layers=jax.tree.map(lambda a: a[1:], jp["layers"]))
    jh2, _ = jllama.forward_hidden_chunk(cfg1, jp1, hidden, positions,
                                         jllama.init_kv_pools(cfg1, 5, 16, jnp.float32),
                                         table, seq, block_size=16)
    th2, _ = tllama.forward_hidden_chunk(
        tcfg, dict(tp, layers={k: v[1:] for k, v in tp["layers"].items()}),
        torch.from_numpy(hidden), torch.from_numpy(positions),
        tllama.init_kv_pools(dataclasses.replace(tcfg, num_layers=1), 5, 16, torch.float32,
                             "cpu"),
        torch.from_numpy(table), torch.from_numpy(seq))
    np.testing.assert_allclose(th2.numpy()[0, valid], np.asarray(jh2)[0, valid], atol=ENC_ATOL)
    int8 = tllama.init_kv_pools(tcfg, 5, 16, torch.int8, "cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        tllama.forward_hidden_chunk(tcfg, tp, torch.from_numpy(hidden),
                                    torch.from_numpy(positions), int8,
                                    torch.from_numpy(table), torch.from_numpy(seq))
