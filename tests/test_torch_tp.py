"""Tensor parallelism in the PyTorch port against the JAX package, on the CPU
with gloo ranks (one spawned process a rank beyond rank 0).

- (i) Every leaf of rank r's params, quantized ``{qw, scale}`` leaves
  included, and its KV and scale pools equal shard r of the JAX package's
  ``param_shardings`` / ``kv_sharding`` / ``kv_scale_sharding`` on the
  8-device CPU mesh (``jax.device_put`` and ``addressable_shards`` only).
- Each rank's own build (random init on both routes, a checkpoint, the
  quantized-weight cache) draws exactly the whole tree's values and keeps
  its part: weights quantized whole, then cut.
- (ii) The greedy tokens of ``TorchEngine`` at tp 2 equal the JAX
  single-device engine's on ``llama3-tiny`` in f32, with activation-dtype
  and int8 pools (JAX's own TP claim, ``tests/test_engine_tp.py``); (iii)
  its int8 scale pools equal the JAX single-chip int8 engine's bit for bit.

Failures, refusals and the worker are in ``test_torch_tp_serving.py``, the
MoE at ep 2 in ``test_torch_tp_moe.py``, the card's tests in
``test_torch_tp_gpu.py``. Every group has a short timeout."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models import loader as tloader  # noqa: E402
from distributed_gpu_inference_torch.models.configs import (  # noqa: E402
    get_model_config as tget,
)
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    kv_from_numpy,
    params_from_numpy,
    shard_params_numpy,
    tensor_to_words,
)
from distributed_gpu_inference_torch.parallel.mesh import (  # noqa: E402
    MeshPlan as TMeshPlan,
    choose_backend,
    infer_plan as tinfer,
)
from distributed_gpu_inference_torch.parallel.sharding import shard_kv, shard_tree  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import tp as tp_ranks  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.ops.quantization import quantize_params  # noqa: E402
from distributed_gpu_inference_tpu.parallel import sharding as jsharding  # noqa: E402
from distributed_gpu_inference_tpu.parallel.mesh import MeshPlan, infer_plan, make_mesh  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402
from tests.test_torch_loader import hf_tensors, write_checkpoint  # noqa: E402

MODEL = "llama3-tiny"       # num_kv_heads = 2 → tp 2
CPU2 = ["cpu", "cpu"]
GEOM = dict(max_batch_size=3, max_seq_len=128, block_size=16, prefill_buckets=(16, 32),
            dtype="float32", multi_step=4)
PROMPTS = [[(i * 7 + 3 * j) % 500 + 1 for i in range(5 + 11 * j)] for j in range(3)]


def _bits(a):
    a = tensor_to_words(a) if torch.is_tensor(a) else np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])
    return a


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _req(ds, prompt, n=8, **kw):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0,
                                                          **kw))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Each rank is a process of its own on the same cores (it takes the
    parent's thread count): two threads a process keep a file's ranks from
    crowding the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _short_timeout():
    """A rank that hangs fails a test in 30 s, not in the engine's 120."""
    was = tp_ranks.TIMEOUT_S
    tp_ranks.TIMEOUT_S = 30.0
    yield
    tp_ranks.TIMEOUT_S = was


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(0), jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


def _mesh2():
    return make_mesh(MeshPlan(model=2), jax.devices()[:2], keep_trivial_axes=False)


def _shard_data(arr, rank):
    """Device ``rank``'s shard of a placed JAX array, as numpy."""
    dev = jax.devices()[rank]
    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


# -- (i) the rules ----------------------------------------------------------


@pytest.mark.parametrize("model,quant", [("llama3-tiny", None), ("llama3-tiny", "int8"),
                                         ("llama3-tiny", "fp8"), ("qwen2.5-tiny", None),
                                         ("mixtral-tiny", None), ("mixtral-tiny", "int8")])
def test_param_shards_equal_the_jax_sharding_rules(model, quant):
    params = jllama.init_params(get_model_config(model), jax.random.PRNGKey(1), jnp.float32)
    if quant:
        params = quantize_params(params, quant)
    mesh = _mesh2()
    placed = jax.device_put(params, jsharding.prune_rules(jsharding.param_shardings(mesh),
                                                         params))
    tree = jax.tree.map(np.asarray, params)
    jflat = _flat(placed)
    for rank in range(2):
        ours = _flat(shard_params_numpy(tree, rank, 2))
        assert ours.keys() == jflat.keys()
        for name, leaf in jflat.items():
            want = _shard_data(leaf, rank)
            assert ours[name].shape == want.shape, (name, rank)
            np.testing.assert_array_equal(_bits(ours[name]), _bits(want), err_msg=name)
    # the torch trees cut alike: what TorchEngine(params=...) hands its ranks
    tparams = params_from_numpy(tree, "cpu")
    for rank in range(2):
        for name, leaf in _flat(shard_tree(tparams, rank, 2)).items():
            np.testing.assert_array_equal(_bits(leaf), _bits(_flat(shard_params_numpy(
                tree, rank, 2))[name]), err_msg=name)


def test_kv_and_scale_pools_equal_the_jax_sharding_rules():
    cfg = get_model_config(MODEL)
    rng = np.random.default_rng(2)
    pools = jllama.init_kv_pools(cfg, 5, 16, jnp.int8)
    host = {k: np.asarray(v) for k, v in pools.items()}
    host["k"] = rng.integers(-127, 128, host["k"].shape).astype(np.int8)
    host["v"] = rng.integers(-127, 128, host["v"].shape).astype(np.int8)
    scale = rng.random(host["k_scale"].shape[:3]).astype(np.float32)
    for name in ("k_scale", "v_scale"):
        host[name] = np.repeat(scale[..., None], host[name].shape[-1], -1).astype(
            host[name].dtype)
    mesh = _mesh2()
    placed = {k: jax.device_put(v, jsharding.kv_sharding(mesh)) for k, v in host.items()
              if k in ("k", "v")}
    placed.update({k: jax.device_put(v, jsharding.kv_scale_sharding(mesh))
                   for k, v in host.items() if k.endswith("_scale")})
    ours = kv_from_numpy(host, "cpu")
    for rank in range(2):
        part = shard_kv(ours, rank, 2)
        for name in ("k", "v"):
            np.testing.assert_array_equal(_bits(part[name]), _shard_data(placed[name], rank))
        for name in ("k_scale", "v_scale"):
            # replicated: the whole pool, one scale a (page, token) (JAX
            # repeats it over the D lanes)
            np.testing.assert_array_equal(_bits(part[name]),
                                          _bits(_shard_data(placed[name], rank)[..., 0]))
        pools_r = tllama.init_kv_pools(tget(MODEL), 5, 16, torch.int8, "cpu", tp=2)
        assert {k: tuple(v.shape) for k, v in pools_r.items()} == \
            {k: tuple(v.shape) for k, v in part.items()}


def test_mesh_plan_and_backend_match_the_jax_package():
    for n, kv in ((8, 8), (8, 2), (4, 8), (6, 4), (1, 2)):
        assert dataclasses.asdict(tinfer(n, kv)) == dataclasses.asdict(infer_plan(n, kv))
        assert tinfer(n, kv).nontrivial_axes() == infer_plan(n, kv).nontrivial_axes()
    assert TMeshPlan(data=2, model=4).num_devices == 8
    dev = torch.device
    assert choose_backend([dev("cpu"), dev("cpu")]) == "gloo"
    assert choose_backend([dev("cuda", 0), dev("cuda", 1)]) == "nccl"
    assert choose_backend([dev("cuda", 0), dev("cuda", 0)]) == "gloo"
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        choose_backend([dev("cpu"), dev("cuda", 0)])


# -- each rank's own build -----------------------------------------------------


def _same_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert tuple(fa[k].shape) == tuple(fb[k].shape), k
        np.testing.assert_array_equal(_bits(fa[k]), _bits(fb[k]), err_msg=k)


@pytest.mark.parametrize("model,quant", [("llama3-tiny", None), ("llama3-tiny", "int8"),
                                         ("mixtral-tiny", "int8"), ("qwen2.5-tiny", "fp8")])
def test_a_ranks_random_init_is_the_whole_trees_cut(model, quant):
    """The trap: a rank draws every leaf (or streamed slice) as the one-rank
    init draws it, quantizes it whole, then keeps its part."""
    cfg = tget(model)
    whole = tloader.load_or_init_params(cfg, None, "bfloat16", 5, "cpu", quant)
    streamed = tloader.init_quantized_streamed(cfg, quant, "bfloat16", 5, "cpu") \
        if quant else None
    for rank in range(2):
        _same_trees(shard_tree(whole, rank, 2), tloader.load_or_init_params(
            cfg, None, "bfloat16", 5, "cpu", quant, shard=(rank, 2)))
        if quant:
            _same_trees(shard_tree(streamed, rank, 2), tloader.init_quantized_streamed(
                cfg, quant, "bfloat16", 5, "cpu", shard=(rank, 2)))


@pytest.mark.parametrize("model,quant", [("llama3-tiny", "int8"), ("mixtral-tiny", None),
                                         ("qwen2.5-tiny", "int8")])
def test_a_ranks_checkpoint_and_cache_loads_are_the_whole_trees_cut(tmp_path, model, quant):
    cfg = tget(model)
    d = write_checkpoint(tmp_path / "ckpt", hf_tensors(cfg, seed=3), shards=2)
    whole = tloader.load_hf_llama(d, cfg, dtype="float32", device="cpu",
                                  quantization=quant)
    for rank in range(2):
        _same_trees(shard_tree(whole, rank, 2), tloader.load_hf_llama(
            d, cfg, dtype="float32", device="cpu", quantization=quant, shard=(rank, 2)))
    if quant:
        path = tmp_path / "cache.safetensors"
        assert tloader.save_quant_cache(path, whole) > 0
        for rank in range(2):
            _same_trees(shard_tree(whole, rank, 2),
                        tloader.load_quant_cache(path, cfg, "cpu", shard=(rank, 2)))


# -- (ii), (iii) the engine against the JAX single-device engine -----------------


def _engines(weights, kv, **over):
    geom = dict(GEOM, kv_cache_dtype=kv, **over)
    jeng = jengine.TPUEngine(MODEL, jengine.EngineConfig(**geom), params=weights[0])
    teng = tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom),
                               params=params_from_numpy(weights[1], "cpu"),
                               rank_devices=CPU2)
    return jeng, teng


def _drive(eng, ds):
    """One call sequence for both packages: a wave through multi-step
    decode, single steps, and a prefix hit whose shared tail page is
    copied on write."""
    prefix = [(i * 13 + 1) % 500 for i in range(40)]
    a = [r.token_ids for r in eng.generate([_req(ds, p) for p in PROMPTS],
                                           use_multi_step=True)]
    b = [r.token_ids for r in eng.generate([_req(ds, p, 6) for p in PROMPTS[:2]],
                                           use_multi_step=False)]
    c = eng.generate([_req(ds, prefix, 2)], use_multi_step=True)[0].token_ids
    d = eng.generate([_req(ds, prefix + [7, 8, 9, 10], 8)], use_multi_step=True)[0]
    return a, b, c, d.token_ids, d.cached_tokens


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32-pools", "int8-pools"])
def test_tp2_greedy_streams_equal_the_jax_single_device_engine(weights, kv):
    jeng, teng = _engines(weights, kv)
    try:
        assert teng.tp == 2 and teng.get_stats()["tp"]["backend"] == "gloo"
        # rank 0 holds its shard: one of the two KV heads
        assert teng.kv["k"].shape[2] == 1 and teng.params["layers"]["wq"].shape[-1] == 32
        want = _drive(jeng, jds)
        got = _drive(teng, tds)
        assert got == want
        assert got[-1] >= 32        # the prefix hit
        stats = teng.rank_collective_stats()
        assert stats[0]["all_reduce"] == stats[1]["all_reduce"] > 0
        assert stats[0]["broadcast"] == stats[1]["broadcast"] > 0
        if kv == "int8":
            # (iii) scale pools bit-identical to the JAX single-chip int8
            # engine's, and replicated alike on both ranks
            pools = teng.rank_pools()
            for name in ("k_scale", "v_scale"):
                want_bits = _bits(np.asarray(jeng.kv[name])[..., 0])
                np.testing.assert_array_equal(pools[0][name].view(np.uint16), want_bits)
                np.testing.assert_array_equal(pools[1][name], pools[0][name])
    finally:
        teng.shutdown()


def test_tp2_int8_weights_and_pools_equal_the_one_rank_engine():
    """int8 weights quantized whole then cut, int8 pools through the
    max-reduced quantize: the streams and the scale pools of the one-rank
    engine on the same random init (f32)."""
    geom = dict(GEOM, quantization="int8", kv_cache_dtype="int8")
    one = tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom), seed=4, device="cpu")
    two = tengine.TorchEngine(MODEL, tengine.EngineConfig(**geom), seed=4,
                              rank_devices=CPU2)
    try:
        assert _drive(two, tds) == _drive(one, tds)
        for name in ("k_scale", "v_scale"):
            assert torch.equal(two.kv[name], one.kv[name])
        # rank 0's codes are the one-rank engine's for its KV head
        assert torch.equal(two.kv["k"], one.kv["k"][:, :, :1])
    finally:
        two.shutdown()
