"""The port's sampler against the JAX package's: greedy tokens and the
shared top-k/top-p masking are identical; seeded draws come from a
``torch.Generator`` (not JAX's threefry bits), so they are held to their
own contract — inside the nucleus, reproducible per (key, position), and
independent of the batch neighbours."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
