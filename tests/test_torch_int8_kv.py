"""Quantized KV pools (int8 with per-token scales, fp8 e4m3) and int8
weights in the PyTorch port against the JAX package.

- The int8-KV contract (``quantize_token_rows``, ``quantize_kv_pool``) is
  BIT-IDENTICAL to JAX's; the port's compact scale pool ``[N, Bk]`` holds
  exactly the scale JAX repeats over the D lanes, and the bridge moves
  pools and scales both ways bit for bit.
- The ragged and fused-decode plain versions (what the wrappers run on CPU
  tensors) over int8 and fp8 pools against the Pallas kernels in interpret
  mode: outputs within bf16 tolerance (the Pallas kernels round q, the
  dequantized K/V and the softmax weights to bf16 for their dots: atol =
  rtol = 2e-2), and, after the fused write, code pools and scale pools
  bit-identical. Against the compiled XLA read (the JAX engine's path on
  CPU: same f32 arithmetic, only the summation order differs) 2e-5.
- ``forward_chunk`` with int8 weights and int8 KV against JAX's on the
  same bridged weights, and greedy engine streams identical to the JAX
  engine for ``quantization="int8", kv_cache_dtype="int8"`` (and fp8/fp8),
  a prefix-cache copy-on-write case included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models.configs import (  # noqa: E402
    get_model_config as tget,
)
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    array_to_tensor,
    kv_from_numpy,
    kv_to_numpy,
    params_from_numpy,
    tensor_to_words,
)
from distributed_gpu_inference_torch.ops import paged_attention as tpa  # noqa: E402
from distributed_gpu_inference_torch.ops.attention import (  # noqa: E402
    paged_attention_ref,
    quantize_kv_pool,
    quantize_token_rows,
)
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.ops import paged_attention_pallas as jpp  # noqa: E402
from distributed_gpu_inference_tpu.ops.attention import paged_attention_xla  # noqa: E402
from distributed_gpu_inference_tpu.ops.quantization import quantize_params  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

LOOSE = dict(atol=2e-2, rtol=2e-2)
TIGHT = dict(atol=2e-5, rtol=2e-5)


def _bits(a):
    a = tensor_to_words(a) if torch.is_tensor(a) else np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_row_contract_bit_identical(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 2, 64)) * rng.uniform(0.01, 30, (3, 5, 1, 1))).astype(np.float32)
    x[1, 2] = 0.0                                    # an all-zero token: floor 1e-6
    if dtype == "bfloat16":
        x = _bf16(x)
    # the contract as the JAX engine runs it: compiled
    jq, js = jax.jit(jpp._quantize_token_rows, static_argnums=1)(
        jnp.asarray(x).astype(jnp.float32), (2, 3))
    tq, ts = quantize_token_rows(array_to_tensor(x, "cpu"), (2, 3))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


def test_quantize_kv_pool_compact_layout():
    rng = np.random.default_rng(1)
    pool = _bf16(rng.standard_normal((7, 2, 16, 64)) * 3)
    jq, js = jpp.quantize_kv_pool(jnp.asarray(pool))
    tq, ts = quantize_kv_pool(array_to_tensor(pool, "cpu"))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tuple(ts.shape) == (7, 16) and ts.dtype == torch.bfloat16
    js = _bits(js)                                   # [N, Bk, D] lane-replicated
    assert (js == js[..., :1]).all()
    np.testing.assert_array_equal(_bits(ts), js[..., 0])
    # the bridge: JAX's lane-replicated pools in, the same bits back out
    jpools = {"k": np.asarray(jq)[None], "v": np.asarray(jq)[None],
              "k_scale": np.asarray(jpp.quantize_kv_pool(jnp.asarray(pool))[1])[None],
              "v_scale": np.asarray(jpp.quantize_kv_pool(jnp.asarray(pool))[1])[None]}
    tpools = kv_from_numpy(jpools, "cpu")
    assert tuple(tpools["k_scale"].shape) == (1, 7, 16)
    back = kv_to_numpy(tpools)
    for name, arr in jpools.items():
        np.testing.assert_array_equal(_bits(back[name]), _bits(arr), err_msg=name)


def _quant_pools(kind, k, v):
    """(JAX pools + lane-replicated scales, port pools + compact scales) of
    one layer [N, Hkv, Bk, D] from f32 values."""
    if kind == "int8":
        jk, jks = jpp.quantize_kv_pool(jnp.asarray(_bf16(k)))
        jv, jvs = jpp.quantize_kv_pool(jnp.asarray(_bf16(v)))
        t = kv_from_numpy({"k": np.asarray(jk)[None], "v": np.asarray(jv)[None],
                           "k_scale": np.asarray(jks)[None],
                           "v_scale": np.asarray(jvs)[None]}, "cpu")
        return ((jk, jv, jks, jvs),
                (t["k"][0], t["v"][0], t["k_scale"][0], t["v_scale"][0]))
    jk = jnp.asarray(k).astype(jnp.float8_e4m3fn)
    jv = jnp.asarray(v).astype(jnp.float8_e4m3fn)
    t = kv_from_numpy({"k": np.asarray(jk), "v": np.asarray(jv)}, "cpu")
    return (jk, jv, None, None), (t["k"], t["v"], None, None)


def _ragged_case(seed):
    rng = np.random.default_rng(seed)
    b, s, nh, hkv, d, bk, m = 4, 16, 4, 2, 128, 16, 6
    n = 1 + b * m
    k = (rng.standard_normal((n, hkv, bk, d)) * 2).astype(np.float32)
    v = rng.standard_normal((n, hkv, bk, d)).astype(np.float32)
    q = _bf16(rng.standard_normal((b, s, nh, d)))
    tables = np.arange(1, n, dtype=np.int32).reshape(b, m)
    tables[3, :2] = tables[0, :2]                    # a shared prefix
    spans = [(1, 40), (16, 70), (0, 0), (5, 90)]     # (live queries, kv_len)
    pos = np.full((b, s), -1, np.int32)
    lens = np.zeros((b,), np.int32)
    for i, (nq, kv_len) in enumerate(spans):
        lens[i] = kv_len
        pos[i, :nq] = np.arange(kv_len - nq, kv_len)
    return q, k, v, tables, pos, lens


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_ragged_plain_matches_pallas_interpret(kind, window):
    q, k, v, tables, pos, lens = _ragged_case(2)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _quant_pools(kind, k, v)
    want = jpp.ragged_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(lens),
        16, window=window, interpret=True, k_scale=jks, v_scale=jvs)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    got = tpa.ragged_paged_attention(array_to_tensor(q, "cpu"), tk, tv, t(tables), t(pos),
                                     t(lens), 16, window=window, k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **LOOSE)
    assert np.all(got.float().numpy()[pos < 0] == 0.0)
    # the same read in f32 against the XLA path compiled, as the JAX engine
    # runs it (its bf16 dequant product reaches f32 unrounded): only the
    # summation order differs
    qf = np.asarray(q, np.float32)
    xla = jax.jit(paged_attention_xla, static_argnames=("block_size", "window"))
    want = xla(jnp.asarray(qf), jk, jv, jnp.asarray(tables), jnp.asarray(pos),
               jnp.asarray(lens), block_size=16, window=window, k_scale=jks, v_scale=jvs)
    got = paged_attention_ref(torch.from_numpy(qf), tk, tv, t(tables), t(pos), t(lens), 16,
                              window=window, k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_fused_plain_matches_pallas_interpret(kind, window):
    rng = np.random.default_rng(3)
    L, b, nh, hkv, d, bk, m = 2, 4, 4, 2, 128, 16, 4
    n = 1 + b * m
    k = (rng.standard_normal((L, n, hkv, bk, d)) * 2).astype(np.float32)
    v = rng.standard_normal((L, n, hkv, bk, d)).astype(np.float32)
    q = _bf16(rng.standard_normal((b, 1, nh, d)))
    nk = _bf16(rng.standard_normal((b, 1, hkv, d)) * 3)
    nv = _bf16(rng.standard_normal((b, 1, hkv, d)))
    if kind == "fp8":
        nk[0, 0, 0, :4] = _bf16([470.0, -500.0, 440.0, 464.0])   # past e4m3's range
    tables = np.arange(1, n, dtype=np.int32).reshape(b, m)
    lens = np.array([17, 40, 0, 64], np.int32)                   # row 2 inactive
    tables[2] = 0
    pos = (lens - 1)[:, None].astype(np.int32)
    jpools = [_quant_pools(kind, k[i], v[i]) for i in range(L)]
    jk = jnp.stack([p[0][0] for p in jpools])
    jv = jnp.stack([p[0][1] for p in jpools])
    tk = torch.stack([p[1][0] for p in jpools])
    tv = torch.stack([p[1][1] for p in jpools])
    scales = {}
    if kind == "int8":
        scales = dict(k_scale=jnp.stack([p[0][2] for p in jpools]),
                      v_scale=jnp.stack([p[0][3] for p in jpools]))
        tks = torch.stack([p[1][2] for p in jpools])
        tvs = torch.stack([p[1][3] for p in jpools])
    new_dt = jnp.bfloat16 if kind == "int8" else jnp.float8_e4m3fn
    res = jpp.paged_decode_attention_fused(
        jnp.asarray(q), jnp.asarray(nk).astype(new_dt), jnp.asarray(nv).astype(new_dt),
        jk, jv, jnp.int32(1), jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(lens), 16,
        window=window, interpret=True, **scales)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    kw = dict(k_scale=tks, v_scale=tvs) if kind == "int8" else {}
    out, _, _ = tpa.paged_decode_attention_fused(
        array_to_tensor(q, "cpu"), array_to_tensor(nk, "cpu"), array_to_tensor(nv, "cpu"),
        tk, tv, 1, t(tables), t(pos), t(lens), 16, window=window, **kw)
    # fp8: row 0's new K row overflows to NaN in both packages (checked in
    # the pools below); what its attention makes of a NaN key is not held
    live = slice(1, None) if kind == "fp8" else slice(None)
    np.testing.assert_allclose(out.float().numpy()[live],
                               np.asarray(res[0], np.float32)[live], **LOOSE)
    assert np.all(out.float().numpy()[2] == 0.0)
    np.testing.assert_array_equal(_bits(tk), _bits(res[1]))
    np.testing.assert_array_equal(_bits(tv), _bits(res[2]))
    if kind == "int8":
        for got, want in ((tks, res[3]), (tvs, res[4])):
            w = _bits(want)
            assert (w == w[..., :1]).all()
            np.testing.assert_array_equal(_bits(got), w[..., 0])


def test_forward_chunk_int8_weights_and_kv_match_jax():
    bs, m = 16, 4
    jcfg = get_model_config("llama3-tiny", dtype="float32")
    tcfg = tget("llama3-tiny", dtype="float32")
    jparams = quantize_params(jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32),
                              "int8")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jkv = jllama.init_kv_pools(jcfg, 1 + 3 * m, bs, jnp.int8)
    tkv = kv_from_numpy(jax.tree.map(np.asarray, jkv), "cpu")
    assert tuple(tkv["k_scale"].shape) == (jcfg.num_layers, 1 + 3 * m, bs)
    tables = np.arange(1, 1 + 3 * m, dtype=np.int32).reshape(3, m)
    tables[2] = 0
    rng = np.random.default_rng(4)
    for spans, width in (([(0, 12), (0, 16), (0, 0)], 16),
                         ([(12, 16), (16, 8), (0, 0)], 16),
                         ([(28, 1), (24, 1), (0, 0)], 1)):
        toks = rng.integers(0, 512, (3, width)).astype(np.int32)
        pos = np.full((3, width), -1, np.int32)
        for i, (off, cnt) in enumerate(spans):
            pos[i, :cnt] = np.arange(off, off + cnt)
        lens = np.array([off + cnt for off, cnt in spans], np.int32)
        jout = jllama.forward_chunk(jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos), jkv,
                                    jnp.asarray(tables), jnp.asarray(lens), block_size=bs)
        jkv = jout.kv
        tout = tllama.forward_chunk(tcfg, tparams, torch.from_numpy(toks),
                                    torch.from_numpy(pos), tkv, torch.from_numpy(tables),
                                    torch.from_numpy(lens), block_size=bs)
        np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(tout.logits.numpy().argmax(-1),
                                      np.asarray(jout.logits).argmax(-1))
        # codes agree to within one step (an f32 projection summed in another
        # order can land a value on the other side of a rounding boundary)
        for name in ("k", "v"):
            diff = np.abs(tkv[name].numpy().astype(np.int32) - np.asarray(jkv[name], np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tkv[name].float().numpy(),
                                       np.asarray(jkv[name], np.float32)[..., 0], rtol=1e-2)
    assert not tkv["k"][:, 0].any() and not tkv["k_scale"][:, 0].any()


GEOM = dict(max_batch_size=2, max_seq_len=128, block_size=16, prefill_buckets=(16, 32),
            dtype="float32", multi_step=4)


@pytest.fixture(scope="module")
def weights():
    cfg = get_model_config("llama3-tiny", dtype="float32")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


def _req(ds, prompt, n):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, temperature=0.0))


@pytest.mark.parametrize("quant,kv", [("int8", "int8"), ("fp8", "fp8")])
def test_greedy_engine_streams_identical(weights, quant, kv):
    jparams, tree = weights
    geom = dict(GEOM, quantization=quant, kv_cache_dtype=kv, enable_prefix_cache=True)
    j = jengine.TPUEngine("llama3-tiny", jengine.EngineConfig(**geom), params=jparams)
    t = tengine.TorchEngine("llama3-tiny", tengine.EngineConfig(**geom),
                            params=params_from_numpy(tree, "cpu"), device="cpu")
    assert t.kv["k"].dtype == (torch.int8 if kv == "int8" else torch.float8_e4m3fn)
    assert ("k_scale" in t.kv) == (kv == "int8")
    prefix = [(i * 13 + 1) % 500 for i in range(40)]
    outs = []
    for eng, ds in ((j, jds), (t, tds)):
        a = eng.generate([_req(ds, prefix, 2)], use_multi_step=True)[0]
        # a prefix hit whose shared tail page is copied on write
        b = eng.generate([_req(ds, prefix + [7, 8, 9, 10], 8)], use_multi_step=True)[0]
        c = eng.generate([_req(ds, [(i * 29 + 3) % 500 for i in range(20)], 10),
                          _req(ds, [5, 6, 7], 6)], use_multi_step=False)
        outs.append((a.token_ids, b.token_ids, b.cached_tokens,
                     [r.token_ids for r in c]))
    assert outs[1] == outs[0]
    assert outs[1][2] >= 32


def test_copy_on_write_copies_scale_pages(weights):
    # a page without its scale is garbage: CoW copies move both, every layer
    _, tree = weights
    t = tengine.TorchEngine("llama3-tiny", tengine.EngineConfig(**GEOM, kv_cache_dtype="int8"),
                            params=params_from_numpy(tree, "cpu"), device="cpu")
    t.kv["k"][:, 3] = torch.randint(-127, 128, t.kv["k"][:, 3].shape, dtype=torch.int8)
    t.kv["k_scale"][:, 3] = torch.rand(t.kv["k_scale"][:, 3].shape).to(torch.bfloat16)
    t.kv["v_scale"][:, 3] = torch.rand(t.kv["v_scale"][:, 3].shape).to(torch.bfloat16)
    t.manager.pending.copies.append((3, 5))
    t._apply_pending()
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(t.kv[name][:, 5], t.kv[name][:, 3]), name
    assert t.kv["k_scale"][:, 5].any() and t.manager.pending.empty
