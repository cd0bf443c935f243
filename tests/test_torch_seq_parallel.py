"""``TorchEngine`` on a ``seq`` axis of 2 (``mesh=MeshPlan(seq=2)``, two
gloo ranks on the CPU) against the JAX single-chip ``TPUEngine`` on the same
``llama3-tiny`` weights in f32: the port of the JAX package's slow
``tests/test_engine_seq_parallel.py``, greedy streams identical.

- ring and Ulysses long-prompt prefill (ONE seq-parallel pass for a fresh
  prompt longer than the largest bucket; the JAX oracle chunks it), decode
  continuing on the pools that pass wrote, and short prompts that keep the
  batched path;
- block-sharded pools (``kv_seq_sharded``): short and long prompts, a
  batch wave, a prefix-cache hit, a chunked continuation over a cached
  prefix, the chunk-interleaved admission API, int8 pools, and the
  batcher's split admission (``supports_ragged`` false);
- each rank holds 1/2 of the blocks, and its pools hold the pages the
  one-device engine's pools hold at the same global ids."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.parallel.mesh import MeshPlan  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import tp as tp_ranks  # noqa: E402
from distributed_gpu_inference_torch.runtime.batcher import (  # noqa: E402
    BatcherConfig,
    BatcherServing,
)
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"       # 2 KV heads: Ulysses takes seq 2
SEQ2 = dict(rank_devices=["cpu", "cpu"], mesh=MeshPlan(seq=2))


def _geom(**kw):
    base = dict(max_batch_size=2, max_seq_len=256, block_size=16, prefill_buckets=(16,),
                multi_step=4, dtype="float32", enable_prefix_cache=False)
    base.update(kw)
    return base


def _req(ds, prompt, n=6):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0))


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 500, n)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _short_timeout():
    was = tp_ranks.TIMEOUT_S
    tp_ranks.TIMEOUT_S = 30.0
    yield
    tp_ranks.TIMEOUT_S = was


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(get_model_config(MODEL), jax.random.PRNGKey(0), jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def oracles(weights):
    """JAX single-chip engines by (KV pool, prefix cache)."""
    cache = {}

    def get(kv=None, prefix=False):
        if (kv, prefix) not in cache:
            cache[kv, prefix] = jengine.TPUEngine(
                MODEL, jengine.EngineConfig(**_geom(kv_cache_dtype=kv,
                                                    enable_prefix_cache=prefix)),
                params=weights[0])
        return cache[kv, prefix]
    return get


def _want(oracles, prompt, n=6, kv=None, multi=True):
    return oracles(kv).generate([_req(jds, prompt, n)], use_multi_step=multi)[0].token_ids


def _port(weights, **kw):
    return tengine.TorchEngine(MODEL, tengine.EngineConfig(**_geom(**kw)),
                               params=params_from_numpy(weights[1], "cpu"), **SEQ2)


@pytest.fixture(scope="module")
def engines(weights):
    """Port engines at seq 2, one per regime, shared by the tests that only
    generate on them."""
    out = {"ring": _port(weights), "ulysses": _port(weights, seq_parallel_impl="ulysses"),
           "sharded": _port(weights, kv_seq_sharded=True)}
    yield out
    for eng in out.values():
        eng.shutdown()


# -- seq-parallel prefill over replicated pools ----------------------------------


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_long_prefill_matches_the_single_chip_engine(engines, oracles, impl):
    eng = engines[impl]
    before = eng.stats.get("seq_parallel_prefills", 0)
    prompt = _prompt(1 if impl == "ring" else 2, 96)     # 6x the largest bucket
    got = eng.generate([_req(tds, prompt)])[0]
    assert eng.stats["seq_parallel_prefills"] == before + 1
    assert got.token_ids == _want(oracles, prompt, multi=False)
    assert got.prompt_tokens == 96
    st = eng.get_stats()["seq"]
    assert st["size"] == 2
    assert (st["ring_hop"] if impl == "ring" else st["all_to_all"]) > 0


def test_decode_continues_on_the_pools_the_pass_wrote(engines, oracles):
    eng = engines["ring"]
    prompt = _prompt(3, 128)
    got = eng.generate([_req(tds, prompt, 12)], use_multi_step=True)[0]
    assert got.token_ids == _want(oracles, prompt, 12)
    assert got.completion_tokens == 12


def test_short_prompts_keep_the_batched_path(engines, oracles):
    eng = engines["ring"]
    before = eng.stats.get("seq_parallel_prefills", 0)
    hops = eng.get_stats()["seq"]["ring_hop"]
    r = eng.generate([_req(tds, list(range(10, 24)), 4)])[0]
    assert eng.stats.get("seq_parallel_prefills", 0) == before
    assert eng.get_stats()["seq"]["ring_hop"] == hops     # rank 0 served alone
    assert r.token_ids == _want(oracles, list(range(10, 24)), 4, multi=False)


def test_int8_pools_take_the_seq_parallel_prefill(weights, oracles):
    eng = _port(weights, kv_cache_dtype="int8")
    try:
        prompt = _prompt(4, 80)
        got = eng.generate([_req(tds, prompt, 8)], use_multi_step=True)[0]
        assert eng.stats["seq_parallel_prefills"] == 1
        assert got.token_ids == _want(oracles, prompt, 8, kv="int8")
    finally:
        eng.shutdown()


# -- block-sharded pools ---------------------------------------------------------------


def test_sharded_pools_serve_short_and_long_prompts(engines, oracles):
    eng = engines["sharded"]
    assert eng.kv["k"].shape[1] * 2 == eng.num_blocks
    for prompt, n in ((_prompt(5, 12), 6), (_prompt(6, 64), 8)):
        got = eng.generate([_req(tds, prompt, n)], use_multi_step=True)[0]
        assert got.token_ids == _want(oracles, prompt, n), len(prompt)


def test_sharded_batch_wave(engines, oracles):
    eng = engines["sharded"]
    pa, pb = _prompt(7, 10), _prompt(8, 14)
    got = eng.generate([_req(tds, pa, 5), _req(tds, pb, 5)])
    want = oracles().generate([_req(jds, pa, 5), _req(jds, pb, 5)])
    assert [g.token_ids for g in got] == [w.token_ids for w in want]


def test_sharded_pool_rounds_up_and_holds_the_one_device_pages(weights):
    """A pool of 9 blocks rounds up to 10 (5 a rank); after one fresh
    prompt each rank's half of the pages holds the same global blocks of a
    one-device engine fed the same prompt."""
    eng = _port(weights, kv_seq_sharded=True, num_blocks=9, max_seq_len=64)
    one = tengine.TorchEngine(MODEL, tengine.EngineConfig(**_geom(num_blocks=10,
                                                                  max_seq_len=64)),
                              params=params_from_numpy(weights[1], "cpu"), device="cpu")
    try:
        assert eng.num_blocks == 10 and eng.kv["k"].shape[1] == 5
        prompt = _prompt(9, 15)
        eng.submit(_req(tds, prompt, 1))
        one.submit(_req(tds, prompt, 1))
        assert (eng._block_tables == one._block_tables).all()
        pools = eng.rank_pools(("k", "v"))
        for r, part in enumerate(pools):
            lo, hi = r * 5, (r + 1) * 5
            for name in ("k", "v"):
                want = one.kv[name][:, lo:hi].numpy()
                # layer 0's rows come from the projections alone: the same
                # bits; deeper layers read attention (dense over the chunk
                # here, paged there) and agree to rounding
                np.testing.assert_array_equal(part[name][0], want[0],
                                              err_msg=f"rank {r} {name}")
                np.testing.assert_allclose(part[name], want, atol=1e-5, rtol=1e-5)
    finally:
        eng.shutdown()


def test_sharded_prefix_cache_hit(weights, oracles):
    eng = _port(weights, kv_seq_sharded=True, enable_prefix_cache=True)
    try:
        rng = np.random.default_rng(11)
        prefix = [int(t) for t in rng.integers(1, 500, 32)]
        assert eng.generate([_req(tds, prefix, 2)], use_multi_step=True)[0] \
            .completion_tokens == 2
        full = prefix + [int(t) for t in rng.integers(1, 500, 12)]
        got = eng.generate([_req(tds, full, 8)], use_multi_step=True)[0]
        assert got.cached_tokens >= 16, "the prefix cache must hit"
        assert got.token_ids == _want(oracles, full, 8)
        # a chunked continuation: a fresh suffix of three chunks after the
        # cached prefix, every chunk read through the chunk op
        eng.generate([_req(tds, prefix, 1)], use_multi_step=True)
        longer = prefix + [int(t) for t in rng.integers(1, 500, 48)]
        got = eng.generate([_req(tds, longer, 8)], use_multi_step=True)[0]
        assert got.cached_tokens >= 16
        assert got.token_ids == _want(oracles, longer, 8)
    finally:
        eng.shutdown()


def test_sharded_chunked_admission_api(engines, oracles):
    eng = engines["sharded"]
    prompt = _prompt(13, 40)
    adm = eng.submit_chunked_start(_req(tds, prompt, 6))
    steps = 0
    while not eng.submit_chunked_step(adm):
        steps += 1
        assert steps < 10
    while eng.slots[adm.slot] is not None and eng.slots[adm.slot].finish_reason is None:
        eng.decode_multi()
    assert eng.finish_slot(adm.slot).token_ids == _want(oracles, prompt, 6)


def test_sharded_int8_pools(weights, oracles):
    eng = _port(weights, kv_seq_sharded=True, kv_cache_dtype="int8")
    try:
        for prompt, n in ((_prompt(14, 20), 6), (_prompt(15, 70), 8)):
            got = eng.generate([_req(tds, prompt, n)], use_multi_step=True)[0]
            assert got.token_ids == _want(oracles, prompt, n, kv="int8")
        # the ranks' scale pools are their halves, never a copy of rank 0's
        s0, s1 = (p["k_scale"] for p in eng.rank_pools())
        assert s0.shape == s1.shape and s0.shape[1] * 2 == eng.num_blocks
    finally:
        eng.shutdown()


def test_the_batcher_keeps_split_admission_on_sharded_pools(engines, oracles):
    eng = engines["sharded"]
    assert not eng.supports_ragged
    assert engines["ring"].supports_ragged
    serving = BatcherServing(eng, BatcherConfig(max_wait_ms=1.0))
    try:
        assert not serving.batcher.use_ragged
        prompts = [_prompt(16, 9), _prompt(17, 40)]
        futs = [serving.submit_async(_req(tds, p, 5)) for p in prompts]
        got = [f.result(timeout=120) for f in futs]
    finally:
        serving.stop()
    for p, g in zip(prompts, got):
        assert g.token_ids == _want(oracles, p, 5)


@pytest.mark.parametrize("rows, lens, kind", [
    # a fresh wave padded to its bucket, and an empty row
    ([[0, 1, 2, -1], [0, 1, -1, -1], [-1, -1, -1, -1]], [3, 2, 0], "dense"),
    # a continuation over a cached prefix
    ([[4, 5, 6, -1]], [7], "chunk"),
    # a row starting at 0 whose length counts keys it does not write
    ([[0, 1, -1, -1]], [5], "chunk"),
    # decode rows beside a fresh one
    ([[0, 1, 2, 3], [9, -1, -1, -1]], [4, 10], "chunk"),
])
def test_a_block_sharded_forward_derives_its_read_from_its_arrays(rows, lens, kind):
    assert tp_ranks.attention_kind(np.asarray(rows, np.int32),
                                   np.asarray(lens, np.int32)) == kind
