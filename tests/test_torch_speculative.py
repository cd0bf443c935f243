"""``runtime/speculative.py`` and the tree-verify pieces of the port against
the JAX package on ``llama3-tiny`` in f32 on the CPU, the same numpy-seeded
weights carried across with ``params_from_numpy`` /
``draft_params_from_numpy``:

- ``TreeTopology``, both config validators (the same accept/reject cases,
  the same messages) and ``k_choices``;
- ``draft_apply`` with and without the EAGLE-3 ``w_feat`` projection,
  ``medusa_logits``, the draft weights' round trip;
- ``paged_tree_attention`` over f32, bf16 and int8 pools and with a
  sliding window; ``forward_tree_chunk`` and ``forward_chunk``'s
  ``collect_layers`` (logits, hiddens, features and the written pools);
- ``_move_rows`` / ``_move_scale_rows``;
- the standalone ``SpeculativeDecoder``: streams and stats equal the JAX
  decoder's (random draft, EAGLE-3 feature layers, int8 KV, a stop token,
  a prefix-cache hit), and with a draft the target always agrees with the
  accepted paths are compacted into the same pools."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    draft_params_from_numpy,
    draft_params_to_numpy,
    kv_from_numpy,
    kv_to_numpy,
    params_from_numpy,
)
from distributed_gpu_inference_torch.ops import attention as tatt  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import speculative as tspec  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.ops import attention as jatt  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import speculative as jspec  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
CFG = get_model_config(MODEL)
ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(CFG, jax.random.PRNGKey(7), jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, copy=True)).to(dtype) if dtype else \
        torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------- topology + configs

@pytest.mark.parametrize("widths", [(1,), (4, 2), (2, 2, 2), (3, 1, 2, 1)])
def test_tree_topology_matches_jax(widths):
    j, t = jspec.TreeTopology(widths), tspec.TreeTopology(widths)
    assert np.array_equal(t.parents, j.parents)
    assert np.array_equal(t.depths, j.depths)
    assert np.array_equal(t.ancestor_mask, j.ancestor_mask)
    assert t.level_slices == j.level_slices
    assert (t.num_nodes, t.max_depth) == (j.num_nodes, j.max_depth)


class _Sharded:
    max_seq_len, block_size, max_blocks_per_seq, kv_seq_sharded = 128, 16, 8, True


SPEC_CASES = [
    (dict(num_draft_tokens=4), dict(max_seq_len=128, block_size=16)),
    (dict(num_draft_tokens=16), dict(max_seq_len=128, block_size=16)),
    (dict(num_draft_tokens=0), dict(max_seq_len=128, block_size=16)),
    (dict(num_draft_tokens=7), dict(max_seq_len=8, block_size=2)),
    (dict(num_draft_tokens=7), dict(max_seq_len=8, block_size=4)),
    (dict(num_draft_tokens=4, oracle_accept_rate=1.5), dict(max_seq_len=128, block_size=16)),
    (dict(num_draft_tokens=4, oracle_accept_rate=0.5), dict(max_seq_len=128, block_size=16)),
    (dict(num_draft_tokens=4, adaptive=True, adaptive_ema=1.0), dict(max_seq_len=128)),
    (dict(num_draft_tokens=4, adaptive=True, adaptive_min_k=5), dict(max_seq_len=128)),
    (dict(num_draft_tokens=4, adaptive=True, adaptive_k_choices=(1, 2)), dict(max_seq_len=128)),
    (dict(num_draft_tokens=4, adaptive=True, adaptive_k_choices=(0, 4)), dict(max_seq_len=128)),
    (dict(num_draft_tokens=6, adaptive=True, adaptive_min_k=2), dict(max_seq_len=128)),
    (dict(num_draft_tokens=4), "sharded"),
]


def _outcome(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("kw,geom", SPEC_CASES)
def test_spec_decode_config_validates_as_jax(kw, geom):
    if geom == "sharded":
        jcfg = tcfg = _Sharded()
    else:
        jcfg = jengine.EngineConfig(max_batch_size=2, **geom)
        tcfg = tengine.EngineConfig(max_batch_size=2, **geom)
    want = _outcome(lambda: jspec.SpecDecodeConfig(**kw).validate(jcfg))
    got = _outcome(lambda: tspec.SpecDecodeConfig(**kw).validate(tcfg))
    assert got == want
    assert tspec.SpecDecodeConfig(**kw).k_choices() == jspec.SpecDecodeConfig(**kw).k_choices()
    if kw.get("num_draft_tokens") in (0, 7) or geom == "sharded":
        assert got is not None


@pytest.mark.parametrize("kw,blocks", [
    (dict(widths=(8, 8, 8), adaptive=False), (2, 16)),
    (dict(widths=(8, 8), adaptive=True, max_depth=4), (32, 16)),
    (dict(widths=(8, 8), adaptive=True, max_depth=4), (5, 16)),
    (dict(widths=(4, 0)), (8, 16)),
    (dict(widths=()), (8, 16)),
    (dict(widths=(4, 2, 2)), (64, 16)),
])
def test_tree_config_validates_as_jax(kw, blocks):
    want = _outcome(lambda: jspec.SpeculativeConfig(**kw).validate_blocks(*blocks))
    got = _outcome(lambda: tspec.SpeculativeConfig(**kw).validate_blocks(*blocks))
    assert got == want


def test_engine_and_decoder_constructors_validate():
    with pytest.raises(ValueError, match="num_draft_tokens"):
        tengine.TorchEngine(MODEL, tengine.EngineConfig(
            max_batch_size=1, max_seq_len=32, prefill_buckets=(16,), dtype="float32",
            speculative=tspec.SpecDecodeConfig(num_draft_tokens=40)), device="cpu")
    with pytest.raises(ValueError, match="widths"):
        tspec.SpeculativeDecoder(MODEL, spec_cfg=tspec.SpeculativeConfig(
            widths=(8, 8, 8), adaptive=False), max_batch_size=1, max_seq_len=32,
            device="cpu")


# ---------------------------------------------------------------- draft heads

@pytest.mark.parametrize("layers", [1, 3])
def test_draft_apply_matches_jax(layers):
    dp = jspec.init_draft_params(CFG, jax.random.PRNGKey(4), dtype=jnp.float32,
                                 num_feature_layers=layers)
    tdp = draft_params_from_numpy(jax.tree.map(np.asarray, dp), "cpu")
    assert set(tdp) == ({"w_fuse", "w_out", "norm"} | ({"w_feat"} if layers > 1 else set()))
    rng = np.random.default_rng(0)
    h = CFG.hidden_size
    emb = rng.standard_normal((3, 2, h)).astype(np.float32)
    fn = jax.jit(functools.partial(jspec.draft_apply, CFG))
    # a k·H-wide feature input takes w_feat; an H-wide one skips it
    for width in sorted({h, layers * h}):
        x = rng.standard_normal((3, 2, width)).astype(np.float32)
        want = np.asarray(fn(dp, jnp.asarray(x), jnp.asarray(emb)))
        got = tspec.draft_apply(CFG, tdp, _t(x), _t(emb)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    back = draft_params_to_numpy(tdp)
    assert all(np.array_equal(back[k], np.asarray(dp[k])) for k in dp)


def test_init_draft_params_layout():
    gen = torch.Generator().manual_seed(1)
    dp = tspec.init_draft_params(CFG, gen, dtype="float32", num_feature_layers=2)
    jdp = jspec.init_draft_params(CFG, jax.random.PRNGKey(1), dtype=jnp.float32,
                                  num_feature_layers=2)
    assert {k: tuple(v.shape) for k, v in dp.items()} == \
        {k: tuple(v.shape) for k, v in jdp.items()}
    assert torch.equal(dp["norm"], torch.ones(CFG.hidden_size))
    with pytest.raises(ValueError, match="draft head"):
        draft_params_from_numpy({"w_fuse": np.zeros((2, 2), np.float32)}, "cpu")


def test_medusa_logits_match_jax(weights):
    jparams, tree = weights
    mp = jspec.init_medusa_params(CFG, jax.random.PRNGKey(1), num_heads=3,
                                  dtype=jnp.float32)
    h = np.random.default_rng(2).standard_normal((2, CFG.hidden_size)).astype(np.float32)
    want = np.asarray(jspec.medusa_logits(CFG, jparams, mp, jnp.asarray(h)))
    got = tspec.medusa_logits(CFG, params_from_numpy(tree, "cpu"),
                              {"w": _t(np.asarray(mp["w"]))}, _t(h)).numpy()
    assert got.shape == (2, 3, CFG.vocab_size)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    mpt = tspec.init_medusa_params(CFG, torch.Generator().manual_seed(0), num_heads=3,
                                   dtype="float32")
    assert tuple(mpt["w"].shape) == (3, CFG.hidden_size, CFG.hidden_size)


# ---------------------------------------------------------------- tree attention

def _tree_case(kind, window):
    rng = np.random.default_rng(11)
    b, nh, hkv, d, bk, m = 2, 4, 2, 16, 16, 4
    topo = tspec.TreeTopology((2, 2))
    n = topo.num_nodes
    k = rng.standard_normal((1 + b * m, hkv, bk, d)).astype(np.float32)
    v = rng.standard_normal((1 + b * m, hkv, bk, d)).astype(np.float32)
    tables = np.arange(1, 1 + b * m, dtype=np.int32).reshape(b, m)
    prefix = np.asarray([20, 33], np.int32)
    q = rng.standard_normal((b, n, nh, d)).astype(np.float32)
    node_pos = (prefix[:, None] + topo.depths[None, :]).astype(np.int32)
    jkw = dict(node_positions=jnp.asarray(node_pos), window=window)
    tkw = dict(node_positions=_t(node_pos), window=window)
    if kind == "int8":
        (kq, ks), (vq, vs) = (tatt.quantize_kv_pool(_t(x)) for x in (k, v))
        jkw.update(k_scale=jnp.asarray(np.repeat(ks.float().numpy()[..., None], d, -1),
                                       jnp.bfloat16),
                   v_scale=jnp.asarray(np.repeat(vs.float().numpy()[..., None], d, -1),
                                       jnp.bfloat16))
        tkw.update(k_scale=ks, v_scale=vs)
        jk, jv, tk, tv = jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()), kq, vq
    elif kind == "bf16":
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        tk, tv = _t(k, torch.bfloat16), _t(v, torch.bfloat16)
    else:
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
    qdt = (jnp.bfloat16, torch.bfloat16) if kind == "bf16" else (jnp.float32, torch.float32)
    jargs = (jnp.asarray(q, qdt[0]), jk, jv, jnp.asarray(tables), jnp.asarray(prefix),
             jnp.asarray(topo.ancestor_mask))
    targs = (_t(q, qdt[1]), tk, tv, _t(tables), _t(prefix), _t(topo.ancestor_mask))
    return jargs, jkw, targs, tkw


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window", [None, 3])
def test_paged_tree_attention_matches_jax(kind, window):
    jargs, jkw, targs, tkw = _tree_case(kind, window)
    fn = jax.jit(functools.partial(jatt.paged_tree_attention, block_size=16, **jkw))
    want = np.asarray(fn(*jargs).astype(jnp.float32))
    got = tatt.paged_tree_attention(*targs, 16, **tkw).float().numpy()
    # bf16 outputs: the f32 results agree to ~1e-6 and round to bf16, so
    # at most one bf16 ulp apart
    tol = dict(rtol=2.0 ** -7, atol=ATOL) if kind == "bf16" else dict(rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want, **tol)
    if window is not None:
        # the window really masks: a wider one changes the output
        wide = tatt.paged_tree_attention(*targs, 16, **dict(tkw, window=64))
        assert not torch.allclose(wide.float(), torch.from_numpy(got))


def _prefilled(weights, kv_dtype):
    """Both packages' pools after a 40-token prefill of two rows."""
    jparams, tree = weights
    tparams = params_from_numpy(tree, "cpu")
    tables = np.arange(1, 1 + 2 * 8, dtype=np.int32).reshape(2, 8)
    toks = np.arange(100, 140, dtype=np.int32)[None].repeat(2, 0)
    toks[1] += 50
    pos = np.arange(40, dtype=np.int32)[None].repeat(2, 0)
    pos[1, 35:] = -1
    lens = np.asarray([40, 35], np.int32)
    jkv = jllama.init_kv_pools(CFG, 17, 16, dtype=kv_dtype)
    fwd = jax.jit(functools.partial(jllama.forward_chunk, CFG, block_size=16))
    jkv = fwd(jparams, jnp.asarray(toks), jnp.asarray(pos), jkv, jnp.asarray(tables),
              jnp.asarray(lens)).kv
    tkv = tllama.init_kv_pools(CFG, 17, 16, {jnp.float32: "float32",
                                             jnp.int8: "int8"}[kv_dtype], "cpu")
    tllama.forward_chunk(CFG, tparams, _t(toks), _t(pos), tkv, _t(tables), _t(lens),
                         block_size=16)
    return jparams, tparams, jkv, tkv, tables, lens


@pytest.mark.parametrize("kv_dtype", [jnp.float32, jnp.int8])
def test_forward_tree_chunk_and_collect_layers_match_jax(weights, kv_dtype):
    jparams, tparams, jkv, tkv, tables, prefix = _prefilled(weights, kv_dtype)
    topo = tspec.TreeTopology((2, 2))
    n = topo.num_nodes
    toks = np.random.default_rng(3).integers(0, CFG.vocab_size, (2, n)).astype(np.int32)
    rope = (prefix[:, None] + topo.depths[None, :]).astype(np.int32)
    cache = (prefix[:, None] + np.arange(n)[None, :]).astype(np.int32)
    cache[1, 5:] = -1                     # node rows that write nothing
    fn = jax.jit(functools.partial(jllama.forward_tree_chunk, CFG, block_size=16,
                                   collect_layers=(0, 1)))
    jout = fn(jparams, jnp.asarray(toks), jnp.asarray(rope), jnp.asarray(cache), jkv,
              jnp.asarray(tables), jnp.asarray(prefix), jnp.asarray(topo.ancestor_mask))
    tout = tllama.forward_tree_chunk(CFG, tparams, _t(toks), _t(rope), _t(cache), tkv,
                                     _t(tables), _t(prefix), _t(topo.ancestor_mask),
                                     block_size=16, collect_layers=(0, 1))
    assert tuple(tout.features.shape) == (2, n, 2 * CFG.hidden_size)
    np.testing.assert_allclose(tout.features[..., CFG.hidden_size:].numpy(),
                               tout.hidden.numpy(), rtol=0, atol=0)
    # int8 pools: codes are rounded from f32 values that agree to ~1e-6, so
    # a code can sit one step apart; the outputs still agree to 1e-4
    atol = ATOL if kv_dtype == jnp.float32 else 1e-4
    for got, want in ((tout.logits, jout.logits), (tout.hidden, jout.hidden),
                      (tout.features, jout.features)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
    got_kv, want_kv = kv_to_numpy(tkv), jax.tree.map(np.asarray, dict(jout.kv))
    if kv_dtype == jnp.float32:
        for name in ("k", "v"):
            np.testing.assert_allclose(got_kv[name], want_kv[name], rtol=0, atol=ATOL)
    else:
        for name in ("k", "v"):
            assert np.abs(got_kv[name].astype(int) - want_kv[name].astype(int)).max() <= 1
    # collect_layers on the plain chunk forward too
    jfwd = jax.jit(functools.partial(jllama.forward_chunk, CFG, block_size=16,
                                     last_only=False, collect_layers=(1, 0)))
    j2 = jfwd(jparams, jnp.asarray(toks[:, :3]), jnp.asarray(cache[:, :3] + 10),
              jllama.init_kv_pools(CFG, 17, 16, dtype=jnp.float32), jnp.asarray(tables),
              jnp.asarray(prefix + 13))
    t2 = tllama.forward_chunk(CFG, tparams, _t(toks[:, :3]), _t(cache[:, :3] + 10),
                              tllama.init_kv_pools(CFG, 17, 16, "float32", "cpu"),
                              _t(tables), _t(prefix + 13), block_size=16, last_only=False,
                              collect_layers=(1, 0))
    np.testing.assert_allclose(t2.features.numpy(), np.asarray(j2.features), rtol=0,
                               atol=ATOL)
    assert tllama.forward_chunk(CFG, tparams, _t(toks[:, :1]), _t(cache[:, :1] + 20),
                                tllama.init_kv_pools(CFG, 17, 16, "float32", "cpu"),
                                _t(tables), _t(prefix + 21), block_size=16).features is None


@pytest.mark.parametrize("int8", [False, True])
def test_move_rows_matches_jax(int8):
    rng = np.random.default_rng(8)
    L, nb, hkv, bk, d = 2, 9, 2, 4, 8
    pool = rng.standard_normal((L, nb, hkv, bk, d)).astype(np.float32)
    scale = rng.standard_normal((L, nb, bk)).astype(np.float32)
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    src = np.asarray([[5, 7, -1], [2, 9, 10]], np.int32)
    dst = np.asarray([[3, 4, 5], [1, -1, 2]], np.int32)
    want = np.asarray(jspec._move_rows(jnp.asarray(pool), jnp.asarray(tables),
                                       jnp.asarray(src), jnp.asarray(dst), bk))
    got = tspec._move_rows(_t(pool), _t(tables), _t(src), _t(dst), bk).numpy()
    assert np.array_equal(got, want) and not np.array_equal(got, pool)
    if int8:
        jscale = np.repeat(scale[..., None], d, -1)
        want = np.asarray(jspec._move_scale_rows(
            jnp.asarray(jscale), jnp.asarray(tables), jnp.asarray(src), jnp.asarray(dst), bk))
        got = tspec._move_scale_rows(_t(scale), _t(tables), _t(src), _t(dst), bk).numpy()
        assert np.array_equal(got, want[..., 0])


# ---------------------------------------------------------------- the tree decoder

def _greedy(ds, prompt, n, **kw):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=n, **kw))


PROMPTS = [list(range(10, 30)), list(range(40, 70))]


def _decoders(weights, widths=(2, 2), feature_layers=None, jparams=None, tparams=None,
              **kw):
    """(JAX decoder, port decoder) on the same target and draft weights."""
    jp, tree = weights
    jparams = jp if jparams is None else jparams
    n_feat = len(feature_layers) if feature_layers else 1
    dp = jspec.init_draft_params(CFG, jax.random.PRNGKey(3), dtype=jnp.float32,
                                 num_feature_layers=n_feat)
    geom = dict(max_batch_size=2, max_seq_len=128, **kw)
    spec = dict(widths=widths, feature_layers=feature_layers)
    jd = jspec.SpeculativeDecoder(CFG, params=jparams, draft_params=dp,
                                  spec_cfg=jspec.SpeculativeConfig(**spec), **geom)
    td = tspec.SpeculativeDecoder(
        CFG, params=tparams or params_from_numpy(tree, "cpu"),
        draft_params=draft_params_from_numpy(jax.tree.map(np.asarray, dp), "cpu"),
        spec_cfg=tspec.SpeculativeConfig(**spec), device="cpu", **geom)
    return jd, td


@pytest.mark.parametrize("variant", [
    dict(),
    dict(feature_layers=(0, 1)),
    dict(kv_cache_dtype="int8", widths=(3, 1)),
])
def test_decoder_streams_and_stats_match_jax(weights, variant):
    jd, td = _decoders(weights, **variant)
    want = jd.generate([_greedy(jds, p, 20) for p in PROMPTS])
    got = td.generate([_greedy(tds, p, 20) for p in PROMPTS])
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert td.get_stats() == jd.get_stats()
    assert td.stats["steps"] > 0


def test_decoder_stream_is_the_engines_greedy_stream_and_stops(weights):
    jp, tree = weights
    # the engine with the decoder's pool dtype (the model's bf16)
    eng = tengine.TorchEngine(MODEL, tengine.EngineConfig(
        max_batch_size=2, max_seq_len=128, prefill_buckets=(16, 32, 64), dtype="float32",
        kv_cache_dtype="bf16"), params=params_from_numpy(tree, "cpu"), device="cpu")
    free = eng.generate([_greedy(tds, PROMPTS[0], 16)])[0].token_ids
    jd, td = _decoders(weights)
    assert td.generate([_greedy(tds, PROMPTS[0], 16)])[0].token_ids == free
    stop_at = free[6]
    want = jd.generate([_greedy(jds, PROMPTS[0], 16, stop_token_ids=(stop_at,))])[0]
    got = td.generate([_greedy(tds, PROMPTS[0], 16, stop_token_ids=(stop_at,))])[0]
    assert got.token_ids == want.token_ids == free[:free.index(stop_at)]
    assert got.finish_reason == want.finish_reason == "stop"
    # a prefix-cache hit reuses the committed blocks and keeps the stream
    again = td.generate([_greedy(tds, PROMPTS[0], 16)])[0]
    assert again.cached_tokens >= 16 and again.token_ids == free
    with pytest.raises(ValueError, match="greedy-only"):
        td.generate([_greedy(tds, PROMPTS[0], 4, temperature=0.7)])


def test_accepted_paths_are_compacted_into_the_same_pools(weights):
    """A target whose final norm is zero gives all-zero logits, so its
    greedy token is always 0 and the draft's top candidate (also 0) is
    accepted at every depth: each round commits a full path and compacts
    the accepted node rows (not the first child of every node) into depth
    order. The pools afterwards equal the JAX decoder's."""
    jp, tree = weights
    jzero = dict(jp, final_norm=jnp.zeros_like(jp["final_norm"]))
    tzero = params_from_numpy(dict(tree, final_norm=np.zeros_like(tree["final_norm"])), "cpu")
    for kv in (None, "int8"):
        jd, td = _decoders(weights, jparams=jzero, tparams=tzero, widths=(2, 1, 1),
                           kv_cache_dtype=kv)
        jd.spec_cfg.adaptive = td.spec_cfg.adaptive = False
        want = jd.generate([_greedy(jds, p, 14) for p in PROMPTS])
        got = td.generate([_greedy(tds, p, 14) for p in PROMPTS])
        assert [r.token_ids for r in got] == [r.token_ids for r in want]
        assert td.get_stats() == jd.get_stats()
        assert td.stats["accepted"] == 3 * td.stats["row_steps"] > 0
        got_kv = kv_to_numpy(td.kv)
        want_kv = jax.tree.map(np.asarray, dict(jd.kv))
        for name in want_kv:
            a = got_kv[name].view(np.int16) if got_kv[name].dtype == np.uint16 else got_kv[name]
            w = want_kv[name]
            w = w.view(np.int16) if w.dtype.itemsize == 2 else w
            # bf16 pools written from f32 rows that agree to ~1e-6: equal
            # bits but for a rare rounding boundary (one ulp)
            assert np.abs(a.astype(np.int64) - w.astype(np.int64)).max() <= 1, (kv, name)
        # and the pools round-trip through the port's layout
        assert set(kv_from_numpy(want_kv, "cpu")) == set(td.kv)
