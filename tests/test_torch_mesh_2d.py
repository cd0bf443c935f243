"""``TorchEngine`` on a seq x model mesh (``MeshPlan(seq=2, model=2)``: four
gloo ranks on the CPU) against the JAX ``TPUEngine`` on the same 2-D mesh
(four of the eight virtual CPU devices ``tests/conftest.py`` sets) and
against the one-device engine, on the same ``llama3-tiny`` weights in f32:

- greedy ids identical for a short prompt, two long prompts through the
  seq-parallel prefill and a wave of two, on the default (f32) and int8
  pools, replicated and block-sharded (``kv_seq_sharded``), ring and
  Ulysses (llama3-tiny's 2 KV heads are 1 a rank at model 2, so Ulysses
  gathers heads over ``model`` before its all-to-alls);
- each rank's pools hold the one-device engine's pages at its (block, head)
  cut, and the collectives ran on the sub-group of their axis;
- a prefix-cache hit and a chunked continuation over the cached prefix;
- a handoff out of the 2-D engine into a tp-2 engine, which continues the
  stream;
- what the 2-D engine still refuses, in the JAX engine's order."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.parallel.mesh import MeshPlan  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import kv_handoff as tkh  # noqa: E402
from distributed_gpu_inference_torch.runtime import tp as tp_ranks  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.parallel.mesh import MeshPlan as JMeshPlan  # noqa: E402
from distributed_gpu_inference_tpu.parallel.mesh import make_mesh  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
MESH = dict(rank_devices=["cpu"] * 4, mesh=MeshPlan(seq=2, model=2))
# (kv pools, block-sharded, seq-parallel impl)
CONFIGS = {
    "f32-replicated-ring": (None, False, "ring"),
    "f32-sharded-ulysses": (None, True, "ulysses"),
    "int8-sharded-ring": ("int8", True, "ring"),
    "int8-replicated-ulysses": ("int8", False, "ulysses"),
}


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 500, n)]


PROMPTS = [_prompt(1, 14), _prompt(2, 100), _prompt(3, 200)]
WAVE = [_prompt(4, 20), _prompt(5, 9)]


def _geom(kv=None, sharded=False, impl="ring", **kw):
    base = dict(max_batch_size=2, max_seq_len=256, block_size=16, prefill_buckets=(16,),
                multi_step=4, dtype="float32", enable_prefix_cache=False, num_blocks=64,
                kv_cache_dtype=kv, kv_seq_sharded=sharded, seq_parallel_impl=impl)
    base.update(kw)
    return base


def _req(ds, prompt, n=6):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
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


def _port(weights, mesh=True, **kw):
    return tengine.TorchEngine(MODEL, tengine.EngineConfig(**_geom(**kw)),
                               params=params_from_numpy(weights[1], "cpu"), device="cpu",
                               **(MESH if mesh else {}))


def _one(weights, **kw):
    kw["sharded"] = False
    return _port(weights, mesh=False, **kw)


def _jax_mesh(weights, **kw):
    mesh = make_mesh(JMeshPlan(seq=2, model=2), jax.devices()[:4], keep_trivial_axes=False)
    return jengine.TPUEngine(MODEL, jengine.EngineConfig(**_geom(**kw)), params=weights[0],
                             mesh=mesh)


def _ids(eng, ds, prompts, n=6):
    return [list(r.token_ids) for r in eng.generate([_req(ds, p, n) for p in prompts])]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_streams_match_jax_on_the_same_mesh_and_one_device(weights, name):
    kv, sharded, impl = CONFIGS[name]
    geom = dict(kv=kv, sharded=sharded, impl=impl)
    eng = _port(weights, **geom)
    one = _one(weights, **geom)
    try:
        jeng = _jax_mesh(weights, **geom)
        for p in PROMPTS:
            got = _ids(eng, tds, [p])
            assert got == _ids(jeng, jds, [p]), (name, len(p))
            assert got == _ids(one, tds, [p]), (name, len(p))
        got = _ids(eng, tds, WAVE)
        assert got == _ids(jeng, jds, WAVE) == _ids(one, tds, WAVE)
        assert eng.stats["seq_parallel_prefills"] == 3      # 100, 200 and 20 tokens
        st = eng.get_stats()
        assert st["mesh"]["seq"] == 2 and st["mesh"]["model"] == 2
        assert st["tp"]["size"] == 2 and st["tp"]["all_reduce"] > 0
        if impl == "ring":
            assert st["seq"]["ring_hop"] > 0 and st["tp"]["all_gather"] == 0
        else:
            # one KV head a rank: Ulysses gathers the heads over model first
            assert st["seq"]["all_to_all"] > 0 and st["tp"]["all_gather"] > 0
        if sharded:
            assert st["seq"]["all_reduce"] > 0      # the partial-softmax merges
        # each rank's pools: the one-device pages at its (block, head) cut
        names = ("k", "v") + (("k_scale", "v_scale") if kv == "int8" else ())
        ranks = eng.rank_pools(names)
        want = one.rank_pools(names)[0]
        for r, pools in enumerate(ranks):
            i, j = divmod(r, 2)
            lo, hi = (32 * i, 32 * (i + 1)) if sharded else ((0, 64) if i == 0 else (0, 0))
            for k in names:
                cut = want[k][:, lo:hi]
                if k in ("k", "v"):
                    cut = cut[:, :, j:j + 1]
                assert pools[k].shape == cut.shape, (r, k)
                if kv == "int8":
                    # codes and scales bit for bit (the amax max-reduced over
                    # model, the scales cut over seq only)
                    np.testing.assert_array_equal(pools[k], cut)
                else:
                    # f32 rows a last bit apart where a row-parallel sum over
                    # the model ranks added the partial products in another order
                    np.testing.assert_allclose(pools[k], cut, atol=1e-5, rtol=0)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("name", ["f32-replicated-ring", "int8-sharded-ring"])
def test_prefix_hit_and_chunked_continuation(weights, name):
    kv, sharded, impl = CONFIGS[name]
    geom = dict(kv=kv, sharded=sharded, impl=impl, enable_prefix_cache=True)
    base = _prompt(6, 40)
    follow = base[:32] + _prompt(7, 60)      # two cached blocks, then 4 chunks
    eng = _port(weights, **geom)
    try:
        jeng = _jax_mesh(weights, **geom)
        one = _one(weights, **geom)
        for p in (base, follow):
            got = _ids(eng, tds, [p])
            assert got == _ids(jeng, jds, [p]) == _ids(one, tds, [p]), (name, len(p))
        kvs = eng.get_stats()["kv_cache"]
        assert kvs["prefix_hit_tokens"] >= 32
        # only the fresh prompt took a seq-parallel pass; the continuation
        # over the cached prefix took the chunked path
        assert eng.stats["seq_parallel_prefills"] == 1
    finally:
        eng.shutdown()


def _finish(eng, slot):
    while eng.slots[slot].finish_reason is None:
        eng.decode_multi()
    return list(eng.finish_slot(slot).token_ids)


def test_handoff_out_of_the_2d_engine_into_tp2(weights):
    prompt = _prompt(8, 70)
    pre = _port(weights, kv="int8", sharded=True)
    dec = tengine.TorchEngine(MODEL, tengine.EngineConfig(**_geom(kv="int8")),
                              params=params_from_numpy(weights[1], "cpu"), device="cpu",
                              rank_devices=["cpu", "cpu"])
    try:
        want = _ids(_one(weights, kv="int8"), tds, [prompt], n=8)[0]
        slot = pre.submit(_req(tds, prompt, 8))
        raw = tkh.serialize_handoff(tkh.export_slot_kv(pre, slot))
        pre.finish_slot(slot, cache=False)
        assert pre.get_stats()["mesh"]["all_gather"] > 0     # the pages met on rank 0
        assert _finish(dec, tkh.adopt_kv(dec, tkh.deserialize_handoff(raw))) == want
        assert dec.get_stats()["tp"]["broadcast"] > 0          # pushed to the rank
    finally:
        pre.shutdown()
        dec.shutdown()


def test_refusals_in_the_jax_order(weights):
    tparams = params_from_numpy(weights[1], "cpu")

    def build(mesh, devices, **kw):
        return tengine.TorchEngine(MODEL, tengine.EngineConfig(**_geom(**kw)),
                                   params=tparams, device="cpu", rank_devices=devices,
                                   mesh=mesh)

    with pytest.raises(ValueError, match="no data or stage axis"):
        build(MeshPlan(data=2, seq=2), ["cpu"] * 4)
    with pytest.raises(ValueError, match="num_kv_heads 2 not divisible by model axis 4"):
        build(MeshPlan(seq=2, model=4), ["cpu"] * 8)
    with pytest.raises(ValueError, match="seq x model axes of 2 x 2 need 4 rank devices"):
        build(MeshPlan(seq=2, model=2), ["cpu"] * 2)
    with pytest.raises(ValueError, match="kv_seq_sharded needs a mesh with a seq axis > 1"):
        build(MeshPlan(model=2), ["cpu"] * 2, sharded=True)
    # the JAX engine refuses the same, in the same order
    with pytest.raises(ValueError, match="num_kv_heads 2 not divisible by model axis 4"):
        jengine.TPUEngine(MODEL, jengine.EngineConfig(**_geom()), params=weights[0],
                          mesh=make_mesh(JMeshPlan(seq=2, model=4), jax.devices()[:8],
                                         keep_trivial_axes=False))
    # the plan itself is no longer refused
    assert MeshPlan(seq=2, model=2).engine_axis() == (2, 2)
