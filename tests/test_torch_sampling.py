"""The port's sampler against the JAX package's: greedy tokens and the
shared top-k/top-p masking are identical, and seeded draws reproduce
``jax.random`` bit for bit — ``fold_in``, the threefry random bits, the
uniforms and the Gumbel noise for many keys (exact equality), the sampled
tokens, and a seeded sampled stream through both engines. Besides, the
draws keep their serving contract: inside the nucleus, reproducible per
(key, position), independent of the batch neighbours."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.ops import sampling as ts  # noqa: E402
from distributed_gpu_inference_tpu.ops import sampling as js  # noqa: E402


def _controls():
    temps = np.array([0.0, 0.7, 1.0, 1.3, 0.5, 2.0], np.float32)
    top_k = np.array([0, 0, 5, 40, 1, 0], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.8, 0.3], np.float32)
    return temps, top_k, top_p


def test_greedy_identical_including_ties():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 512)).astype(np.float32)
    logits[1, [7, 300]] = 9.0          # a tie: both pick the first maximum
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    got = ts.greedy_tokens(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == 7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nucleus_logits_identical(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((6, 512)) * 3).astype(np.float32)
    temps, top_k, top_p = _controls()
    jg, jn = js._nucleus_logits(*map(jnp.asarray, (logits, temps, top_k, top_p)))
    tg, tn = ts._nucleus_logits(*map(torch.from_numpy, (logits, temps, top_k, top_p)))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_seeded_sampling_contract():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy((rng.standard_normal((6, 512)) * 3).astype(np.float32))
    temps, top_k, top_p = map(torch.from_numpy, _controls())
    keys = rng.integers(0, 2**32, (6, 2), dtype=np.uint32)
    pos = [10, 11, 12, 13, 14, 15]
    a = ts.sample_tokens_per_slot(logits, keys, pos, temps, top_k, top_p)
    b = ts.sample_tokens_per_slot(logits, keys, pos, temps, top_k, top_p)
    assert torch.equal(a, b)                              # reproducible
    _, nucleus = ts._nucleus_logits(logits, temps, top_k, top_p)
    for i, tok in enumerate(a.tolist()):
        assert nucleus[i, tok] > -1e29                    # inside the nucleus
    assert a[0] == logits[0].argmax()                     # temperature 0: greedy
    assert a[4] == logits[4].argmax()                     # top_k 1: greedy too
    # a row's draw ignores its neighbours: row 3 alone gives the same token
    solo = ts.sample_tokens_per_slot(logits[3:4], keys[3:4], pos[3:4],
                                     temps[3:4], top_k[3:4], top_p[3:4])
    assert solo[0] == a[3]
    # the position is folded in: successive positions draw differently
    draws = {
        int(ts.sample_tokens_per_slot(logits[5:6], keys[5:6], [p], temps[5:6],
                                      top_k[5:6], top_p[5:6])[0])
        for p in range(40)
    }
    assert len(draws) > 1


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, (n, 2), dtype=np.uint32)
    keys[0] = (0, 0)
    keys[1] = (0xFFFFFFFF, 0xFFFFFFFF)
    return keys


def test_fold_in_and_bits_equal_jax_random():
    keys = _keys(48, 6)
    data = np.random.default_rng(7).integers(-5, 1 << 31, 48).astype(np.int32)
    want = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k), d))
                     for k, d in zip(keys, data)])
    got = ts.fold_in(torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    bits = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (1031,))) for k in want])
    np.testing.assert_array_equal(ts.random_bits(got, 1031).numpy(), bits.astype(np.int64))


def test_uniform_and_gumbel_equal_jax_random():
    keys = _keys(64, 8)
    tk = torch.from_numpy(keys.astype(np.int64))
    tiny = np.finfo(np.float32).tiny
    u = np.stack([np.asarray(jax.random.uniform(jnp.asarray(k), (2053,), jnp.float32,
                                                minval=tiny, maxval=1.0)) for k in keys])
    np.testing.assert_array_equal(ts.uniform(tk, 2053).numpy().view(np.uint32),
                                  u.view(np.uint32))
    g = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (2053,), jnp.float32))
                  for k in keys])
    np.testing.assert_array_equal(ts.gumbel(tk, 2053).numpy().view(np.uint32),
                                  g.view(np.uint32))


def test_log_matches_xla_bit_for_bit():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.random(1 << 16), rng.random(1 << 12) * 1e4,
                        rng.random(1 << 12) ** 12, [1.0, 2.0, 0.5, np.finfo(np.float32).tiny,
                                                    0.0, np.inf]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    got = ts.log_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isnan(ts.log_f32(torch.tensor([-1.0, float("nan")])).numpy()).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_sampled_tokens_equal_jax(seed):
    rng = np.random.default_rng(20 + seed)
    logits = (rng.standard_normal((6, 3001)) * 3).astype(np.float32)
    temps, top_k, top_p = _controls()
    keys = _keys(6, seed)
    pos = rng.integers(0, 4000, 6).astype(np.int32)
    want = np.asarray(js.sample_tokens_per_slot(
        *map(jnp.asarray, (logits, keys, pos, temps, top_k, top_p))))
    got = ts.sample_tokens_per_slot(torch.from_numpy(logits), keys, pos,
                                    *map(torch.from_numpy, (temps, top_k, top_p)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_rows_draw_no_noise(monkeypatch):
    calls = []
    real = ts.random_bits
    monkeypatch.setattr(ts, "random_bits", lambda k, n: calls.append(k.shape) or real(k, n))
    logits = torch.randn(4, 50)
    keys = _keys(4, 3)
    zero = torch.zeros(4)
    ts.sample_tokens_per_slot(logits, keys, [1, 2, 3, 4], zero, torch.zeros(4, dtype=torch.int32),
                              torch.ones(4))
    assert calls == []                                     # all greedy: no bits
    temps = torch.tensor([0.0, 0.9, 0.0, 0.0])
    ts.sample_tokens_per_slot(logits, keys, [1, 2, 3, 4], temps,
                              torch.zeros(4, dtype=torch.int32), torch.ones(4))
    assert calls == [(1, 2)]                               # one sampled row, one key


def test_seeded_sampled_engine_stream_identical_to_jax():
    from distributed_gpu_inference_torch.models.convert import params_from_numpy
    from distributed_gpu_inference_torch.runtime import engine as tengine
    from distributed_gpu_inference_torch.utils import data_structures as tds
    from distributed_gpu_inference_tpu.models import llama as jllama
    from distributed_gpu_inference_tpu.models.configs import get_model_config
    from distributed_gpu_inference_tpu.runtime import engine as jengine
    from distributed_gpu_inference_tpu.utils import data_structures as jds

    cfg = get_model_config("llama3-tiny", dtype="float32")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(11), jnp.float32)
    geom = dict(max_batch_size=3, max_seq_len=96, prefill_buckets=(16, 32), multi_step=4,
                dtype="float32")
    j = jengine.TPUEngine("llama3-tiny", jengine.EngineConfig(**geom), params=jparams)
    t = tengine.TorchEngine("llama3-tiny", tengine.EngineConfig(**geom),
                            params=params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
                            device="cpu")
    specs = [  # prompt, sampling (a greedy row shares the batch)
        (list(range(10, 30)), dict(temperature=0.9, top_k=40, top_p=0.95, seed=1234)),
        (list(range(200, 211)), dict(temperature=1.3, seed=(7 << 32) | 99)),
        (list(range(50, 58)), dict(temperature=0.0)),
    ]
    outs = []
    for eng, ds in ((j, jds), (t, tds)):
        reqs = [ds.InferenceRequest(prompt_token_ids=p,
                                    sampling=ds.SamplingParams(max_new_tokens=14, **sp))
                for p, sp in specs]
        outs.append([r.token_ids for r in eng.generate(reqs, use_multi_step=True)])
    assert outs[1] == outs[0]
    assert all(len(x) == 14 for x in outs[1])
