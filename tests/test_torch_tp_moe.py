"""Expert parallelism in the PyTorch port: ``mixtral-tiny`` (four experts,
top-2, two KV heads) at tp 2 on the CPU with a gloo rank — each rank holds
two experts and one KV head, routes every token with the replicated
router and weighs its own experts, and the combine is summed over the
ranks. Its greedy tokens equal the JAX single-device engine's, in f32 with
f32 and int8 weights, and a rank's forward over its experts sums to the
whole layer's."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models.configs import (  # noqa: E402
    get_model_config as tget,
)
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    params_from_numpy,
    shard_params_numpy,
)
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import tp as tp_ranks  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.ops.quantization import quantize_params  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "mixtral-tiny"
GEOM = dict(max_batch_size=3, max_seq_len=128, block_size=16, prefill_buckets=(16, 32),
            dtype="float32", multi_step=4)
PROMPTS = [[(i * 11 + 5 * j) % 500 + 1 for i in range(6 + 10 * j)] for j in range(3)]


def _req(ds, prompt, n=8):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0))


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
def jparams():
    return jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(7), jnp.float32)


def test_each_ranks_experts_sum_to_the_whole_layer(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    cfg = tget(MODEL)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 5, 64)).astype(np.float32))
    lp_of = lambda t: {k: v[0] for k, v in params_from_numpy(t, "cpu")["layers"].items()}
    whole = tllama._moe_mlp(x, lp_of(tree), cfg)
    parts = []
    for rank in range(2):
        lp = lp_of(shard_params_numpy(tree, rank, 2))
        assert lp["we_gate"].shape[0] == 2 and lp["w_router"].shape[-1] == 4
        # a stand-in group that leaves each rank its own combine: the sum of
        # the two is what the all-reduce hands both ranks
        group = types.SimpleNamespace(rank=rank, all_reduce_sum=lambda t: t)
        parts.append(tllama._moe_mlp(x, lp, cfg, group))
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_ep2_greedy_streams_equal_the_jax_single_device_engine(jparams, quant):
    params = quantize_params(jparams, quant) if quant else jparams
    jeng = jengine.TPUEngine(MODEL, jengine.EngineConfig(**GEOM), params=params)
    teng = tengine.TorchEngine(MODEL, tengine.EngineConfig(**GEOM),
                               params=params_from_numpy(jax.tree.map(np.asarray, params),
                                                        "cpu"),
                               rank_devices=["cpu", "cpu"])
    try:
        experts = teng.params["layers"]["we_gate"]
        assert (experts["qw"] if quant else experts).shape[1] == 2
        outs = []
        for eng, ds in ((jeng, jds), (teng, tds)):
            a = [r.token_ids for r in eng.generate([_req(ds, p) for p in PROMPTS],
                                                   use_multi_step=True)]
            b = [r.token_ids for r in eng.generate([_req(ds, p, 5) for p in PROMPTS[1:]],
                                                   use_multi_step=False)]
            outs.append((a, b))
        assert outs[1] == outs[0]
        stats = teng.rank_collective_stats()
        assert stats[0]["all_reduce"] == stats[1]["all_reduce"] > 0
    finally:
        teng.shutdown()
