"""The weight bridge of the PyTorch port: JAX params and KV pools move to
torch tensors bit for bit (bf16 as raw 16-bit words), and the port's model
registry is the JAX package's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models import configs as tconfigs  # noqa: E402
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    kv_from_numpy,
    params_from_numpy,
    tensor_to_words,
)
from distributed_gpu_inference_tpu.models import configs as jconfigs  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402

TINY = ("llama3-tiny", "qwen2.5-tiny", "mistral-tiny", "gemma-tiny")


def _words(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", TINY)
def test_params_round_trip_bit_exact(name, dtype):
    cfg = jconfigs.get_model_config(name)
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.dtype(dtype))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = params_from_numpy(tree, "cpu")
    want = dict(_flat(tree))
    got = dict(_flat(tparams))
    assert sorted(want) == sorted(got)
    for key, arr in want.items():
        t = got[key]
        assert tuple(t.shape) == arr.shape, key
        assert t.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(tensor_to_words(t), _words(arr), err_msg=key)
    # stacked [L, ...] layer leaves keep their layout
    assert tparams["layers"]["wq"].shape[0] == cfg.num_layers
    assert ("lm_head" in tparams) == (not cfg.tie_word_embeddings)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kv_pools_round_trip_bit_exact(dtype):
    cfg = jconfigs.get_model_config("llama3-tiny")
    pools = jllama.init_kv_pools(cfg, 9, 16, jnp.dtype(dtype))
    rng = np.random.default_rng(0)
    filled = {
        k: np.asarray(jnp.asarray(rng.standard_normal(v.shape), jnp.dtype(dtype)))
        for k, v in pools.items()
    }
    tpools = kv_from_numpy(filled, "cpu")
    for k in ("k", "v"):
        assert tuple(tpools[k].shape) == (cfg.num_layers, 9, cfg.num_kv_heads,
                                          16, cfg.head_dim)
        np.testing.assert_array_equal(tensor_to_words(tpools[k]), _words(filled[k]))


def test_registry_matches_jax_package():
    assert sorted(tconfigs.MODEL_REGISTRY) == sorted(jconfigs.MODEL_REGISTRY)
    for name, jcfg in jconfigs.MODEL_REGISTRY.items():
        assert dataclasses.asdict(tconfigs.MODEL_REGISTRY[name]) == \
            dataclasses.asdict(jcfg), name


def test_quantized_and_int8_pools_are_refused():
    # quantized weights and int8 pools are served now; what the bridge
    # still refuses is a malformed int8 pool: scale lanes that disagree
    # (the compact [L, N, Bk] layout would drop information) or one scale
    # pool without the other
    leaf = np.zeros((2, 4, 4), np.int8)
    got = params_from_numpy({"layers": {"wq": {"qw": leaf, "scale": leaf.astype(np.float32)}}},
                            "cpu")
    assert got["layers"]["wq"]["qw"].dtype == torch.int8
    pool = np.zeros((1, 2, 1, 4, 8), np.int8)
    scale = np.ones((1, 2, 4, 8), np.float32)
    bad = scale.copy()
    bad[0, 1, 2, 5] = 2.0
    with pytest.raises(ValueError, match="lanes"):
        kv_from_numpy({"k": pool, "v": pool, "k_scale": bad, "v_scale": scale}, "cpu")
    with pytest.raises(ValueError, match="both"):
        kv_from_numpy({"k": pool, "v": pool, "k_scale": scale}, "cpu")
    ok = kv_from_numpy({"k": pool, "v": pool, "k_scale": scale, "v_scale": scale}, "cpu")
    assert tuple(ok["k_scale"].shape) == (1, 2, 4)
