"""Engine-integrated speculative decoding (``EngineConfig.speculative``) of
``TorchEngine`` against ``TPUEngine`` on ``llama3-tiny`` in f32 on the CPU
(identical arithmetic: greedy byte-identity across decode paths needs it),
the same numpy-seeded target and draft weights in both packages:

- the port's speculating greedy streams equal the JAX *vanilla* engine's,
  for weight seeds 0 and 3, K in {1, 4}, adaptive depth on and off, and an
  int8 KV pool; its accept counts and adaptive depth trace equal the JAX
  speculating engine's;
- the oracle draft's forced schedule, a stop token inside the verify
  window, a mixed sampled/greedy batch, the per-round API;
- ragged rounds with verify rows beside admission chunk rows;
- rollback: after rejected windows the allocator's free list, refcounts
  and prefix index equal a never-speculated engine's, and mid-flight a
  slot holds exactly its committed blocks;
- prefix-cache composition, and a failed round leaving the engine loudly
  unusable with its draft state dropped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    draft_params_from_numpy,
    params_from_numpy,
)
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.runtime import speculative as tspec  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import engine as jengine  # noqa: E402
from distributed_gpu_inference_tpu.runtime import speculative as jspec  # noqa: E402
from distributed_gpu_inference_tpu.utils import data_structures as jds  # noqa: E402

MODEL = "llama3-tiny"
CFG = get_model_config(MODEL)
GEOM = dict(max_batch_size=4, max_seq_len=128, block_size=16, prefill_buckets=(16, 32),
            multi_step=8, dtype="float32")
PROMPTS = [list(range(10, 30)), list(range(40, 70)), list(range(5, 22))]


def _weights(seed):
    jparams = jllama.init_params(CFG, jax.random.PRNGKey(seed), jnp.float32)
    dp = jspec.init_draft_params(CFG, jax.random.PRNGKey(seed + 1), dtype=jnp.float32)
    return jparams, jax.tree.map(np.asarray, jparams), dp


@pytest.fixture(scope="module")
def seeds():
    return {s: _weights(s) for s in (0, 3)}


def _jax(w, spec=None, **over):
    jparams, _, dp = w
    if spec is not None:
        spec = jspec.SpecDecodeConfig(draft_params=dp, **spec)
    return jengine.TPUEngine(MODEL, jengine.EngineConfig(**{**GEOM, **over},
                                                         speculative=spec), params=jparams)


def _port(w, spec=None, **over):
    _, tree, dp = w
    if spec is not None:
        spec = tspec.SpecDecodeConfig(
            draft_params=draft_params_from_numpy(jax.tree.map(np.asarray, dp), "cpu"), **spec)
    return tengine.TorchEngine(MODEL, tengine.EngineConfig(**{**GEOM, **over},
                                                           speculative=spec),
                               params=params_from_numpy(tree, "cpu"), device="cpu")


def _req(ds, prompt, max_new=12, **kw):
    return ds.InferenceRequest(prompt_token_ids=list(prompt),
                               sampling=ds.SamplingParams(max_new_tokens=max_new, **kw))


def _gen(eng, ds, reqs):
    return eng.generate([_req(ds, *r[:2], **r[2]) if len(r) > 2 else _req(ds, *r)
                         for r in reqs], use_multi_step=True)


SPEC_KEYS = ("spec_steps", "spec_slot_steps", "spec_drafted", "spec_accepted",
             "spec_emitted", "decode_calls", "generated_tokens")


def _spec_stats(eng):
    st = eng.get_stats()
    return {k: st[k] for k in SPEC_KEYS + ("spec_accept_rate", "spec_tokens_per_step")}


# ---------------------------------------------------------------- greedy identity

@pytest.fixture(scope="module")
def vanilla(seeds):
    """The JAX vanilla engine's streams, per weight seed and KV pool."""
    out = {}
    for seed, w in seeds.items():
        for kv in (None, "int8"):
            eng = _jax(w, kv_cache_dtype=kv)
            out[seed, kv] = [(r.token_ids, r.finish_reason)
                             for r in _gen(eng, jds, [(p,) for p in PROMPTS])]
    return out


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("adaptive", [False, True])
def test_greedy_streams_equal_jax_vanilla_and_stats_equal_jax_spec(seeds, vanilla, seed, k,
                                                                   adaptive):
    spec = dict(num_draft_tokens=k, adaptive=adaptive)
    t, j = _port(seeds[seed], spec), _jax(seeds[seed], spec)
    t.spec_k_trace, j.spec_k_trace = [], []
    got = [(r.token_ids, r.finish_reason) for r in _gen(t, tds, [(p,) for p in PROMPTS])]
    assert got == vanilla[seed, None]
    _gen(j, jds, [(p,) for p in PROMPTS])
    assert _spec_stats(t) == _spec_stats(j)
    assert t.spec_k_trace == j.spec_k_trace and len(t.spec_k_trace) > 1
    assert t.stats["spec_steps"] > 0 and t.get_stats()["spec_tokens_per_step"] >= 1.0


@pytest.mark.parametrize("seed", [0, 3])
def test_int8_pool_streams_equal_jax_vanilla(seeds, vanilla, seed):
    spec = dict(num_draft_tokens=4)
    t = _port(seeds[seed], spec, kv_cache_dtype="int8")
    got = [(r.token_ids, r.finish_reason) for r in _gen(t, tds, [(p,) for p in PROMPTS])]
    assert got == vanilla[seed, "int8"]
    j = _jax(seeds[seed], spec, kv_cache_dtype="int8")
    _gen(j, jds, [(p,) for p in PROMPTS])
    assert _spec_stats(t) == _spec_stats(j)


def test_adaptive_depth_follows_the_accept_ema(seeds):
    """With the oracle accepting everything the EMA stays at K; with real
    (near-zero) acceptance it decays and the selected depth falls to the
    floor — the same schedule as the JAX engine's."""
    for rate in (1.0, None):
        spec = dict(num_draft_tokens=4, adaptive=True, oracle_accept_rate=rate)
        t, j = _port(seeds[0], spec), _jax(seeds[0], spec)
        t.spec_k_trace, j.spec_k_trace = [], []
        reqs = [(PROMPTS[0], 24, dict(ignore_eos=True))]
        got, want = _gen(t, tds, reqs), _gen(j, jds, reqs)
        assert got[0].token_ids == want[0].token_ids
        assert t.spec_k_trace == j.spec_k_trace
        ks = [k for step in t.spec_k_trace for _, k in step]
        assert (set(ks) == {4}) if rate == 1.0 else (ks[-1] == 1 and ks[0] == 4)


# ---------------------------------------------------------------- oracle, stops, sampling

def test_oracle_schedule_matches_jax(seeds):
    spec = dict(num_draft_tokens=4, oracle_accept_rate=0.5)
    t, j = _port(seeds[0], spec), _jax(seeds[0], spec)
    reqs = [(p, 24, dict(ignore_eos=True)) for p in PROMPTS]
    got, want = _gen(t, tds, reqs), _gen(j, jds, reqs)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert _spec_stats(t) == _spec_stats(j)
    assert abs(t.get_stats()["spec_tokens_per_step"] - 3.0) < 0.25
    t.set_spec_oracle(None)
    assert t.cfg.speculative.oracle_accept_rate is None
    with pytest.raises(ValueError, match="oracle rate"):
        t.set_spec_oracle(1.5)
    with pytest.raises(ValueError, match="no speculative config"):
        _port(seeds[0]).set_spec_oracle(0.5)


def test_stop_token_inside_the_verify_window(seeds):
    """A stop id landing inside an accepted window truncates exactly where
    the JAX engine stops: with real acceptance (against the vanilla
    stream), and with the oracle committing whole windows of drafts."""
    w = seeds[0]
    free = _gen(_jax(w), jds, [(PROMPTS[0], 16)])[0].token_ids
    t = _port(w, dict(num_draft_tokens=4))
    for stop_idx in (1, 5, 6, 10):
        stop = free[stop_idx]
        got = _gen(t, tds, [(PROMPTS[0], 16, dict(stop_token_ids=(stop,)))])[0]
        assert got.token_ids == free[:free.index(stop)] and got.finish_reason == "stop"
    spec = dict(num_draft_tokens=4, oracle_accept_rate=1.0)
    to, jo = _port(w, spec), _jax(w, spec)
    drafts = _gen(jo, jds, [(PROMPTS[1], 20, dict(ignore_eos=True))])[0].token_ids
    for stop_idx in (2, 7, 13):
        stop = drafts[stop_idx]
        reqs = [(PROMPTS[1], 20, dict(stop_token_ids=(stop,)))]
        got, want = _gen(to, tds, reqs)[0], _gen(jo, jds, reqs)[0]
        assert (got.token_ids, got.finish_reason) == (want.token_ids, want.finish_reason)
        assert got.token_ids == drafts[:drafts.index(stop)] and got.finish_reason == "stop"


def test_mixed_sampled_batch_equals_jax(seeds):
    """Sampled slots ride the rounds at one token with the vanilla key
    folds; greedy neighbours keep speculating."""
    w = seeds[3]
    reqs = [(PROMPTS[0], 12, dict(temperature=0.8, top_k=40, top_p=0.9, seed=7)),
            (PROMPTS[1], 12, {}),
            (PROMPTS[2], 12, dict(temperature=0.5, seed=11))]
    want = [r.token_ids for r in _gen(_jax(w), jds, reqs)]
    t, j = _port(w, dict(num_draft_tokens=4)), _jax(w, dict(num_draft_tokens=4))
    assert [r.token_ids for r in _gen(t, tds, reqs)] == want
    _gen(j, jds, reqs)
    assert _spec_stats(t) == _spec_stats(j)
    # only the greedy slot counts as speculating
    assert t.stats["spec_slot_steps"] < t.stats["spec_steps"] * 3


def test_per_round_api_and_slots_joining_mid_flight(seeds, vanilla):
    t = _port(seeds[0], dict(num_draft_tokens=4))
    want = {i: v[0] for i, v in enumerate(vanilla[0, None])}
    s0 = t.submit(_req(tds, PROMPTS[0]))
    out = t.spec_decode_step()
    assert 1 <= len(out[s0]) <= 5
    s1 = t.submit(_req(tds, PROMPTS[1]))
    t.spec_decode_step()
    s2 = t.submit(_req(tds, PROMPTS[2]))
    got = {}
    while t.num_active:
        t.decode_multi(4)
        for i, s in enumerate(list(t.slots)):
            if s is not None and s.finish_reason is not None:
                got[{s0: 0, s1: 1, s2: 2}[i]] = t.finish_slot(i).token_ids
    assert got == want


def _ragged_script(eng, ds):
    """A decode row beside two chunked admissions (one longer than a
    chunk), per-round chunk caps, then decode_multi to the end."""
    first = eng.submit(_req(ds, PROMPTS[0], max_new=14))
    adms = [eng.submit_chunked_start(_req(ds, list(range(40, 110)), max_new=9)),
            eng.submit_chunked_start(_req(ds, PROMPTS[2], max_new=12,
                                          temperature=0.7, seed=5))]
    rnd = 0
    while not all(a.done for a in adms):
        caps = ({adms[0].slot: 20, adms[1].slot: 0} if rnd % 3 == 0
                else {adms[0].slot: 7} if rnd % 3 == 1 else None)
        eng.ragged_round(adms, caps)
        rnd += 1
    while any(s is not None and s.finish_reason is None for s in eng.slots):
        eng.ragged_round([])
    slots = [first] + [a.slot for a in adms]
    return [eng.finish_slot(sl).token_ids for sl in slots], rnd


def test_ragged_rounds_with_verify_rows_match_jax(seeds):
    w = seeds[0]
    want, jrounds = _ragged_script(_jax(w, dtype="float32", prefill_buckets=(16, 32, 64)),
                                   jds)
    spec = dict(num_draft_tokens=4, adaptive=True)
    t = _port(w, spec, prefill_buckets=(16, 32, 64))
    j = _jax(w, spec, prefill_buckets=(16, 32, 64))
    t.spec_k_trace, j.spec_k_trace = [], []
    got, trounds = _ragged_script(t, tds)
    assert got == want and trounds == jrounds
    assert [len(x) for x in got] == [14, 9, 12]
    _ragged_script(j, jds)
    assert _spec_stats(t) == _spec_stats(j) and t.spec_k_trace == j.spec_k_trace
    assert t.stats["ragged_rounds"] == j.stats["ragged_rounds"] > 3


# ---------------------------------------------------------------- rollback, cache, failure

def _fingerprint(eng):
    m = eng.manager
    return {"free": m.num_free, "cached": len(m.cached_lru), "radix": len(m.radix),
            "metas": len(m.metas), "active": len(m.seq_blocks),
            "refcounts_zero": all(meta.ref_count == 0 for meta in m.metas.values())}


@pytest.mark.parametrize("kv", [None, "int8"])
def test_rollback_leaves_the_allocator_as_a_never_speculated_engine(seeds, kv):
    w = seeds[3]
    plain, spec = _port(w, kv_cache_dtype=kv), _port(w, dict(num_draft_tokens=4),
                                                      kv_cache_dtype=kv)
    reqs = [(p, 10) for p in PROMPTS]
    a, b = _gen(plain, tds, reqs), _gen(spec, tds, reqs)
    assert [r.token_ids for r in a] == [r.token_ids for r in b]
    fp = _fingerprint(spec)
    assert fp == _fingerprint(plain)
    assert fp["refcounts_zero"] and fp["active"] == 0
    assert fp["free"] + fp["cached"] == spec.manager.num_blocks - 1
    for p, r in zip(PROMPTS, b):
        full = p + r.token_ids
        assert len(spec.manager.radix.match_prefix(full)) == \
            len(plain.manager.radix.match_prefix(full))
    # mid-flight a slot holds exactly the blocks of its committed +
    # pending tokens after every round
    slot = spec.submit(_req(tds, PROMPTS[0], max_new=24))
    s = spec.slots[slot]
    for _ in range(4):
        spec.spec_decode_step()
        held = len(spec.manager.seq_blocks[s.seq_id])
        assert held == max(1, -(-len(spec.manager.seq_tokens[s.seq_id]) // 16))
    spec.finish_slot(slot)


def test_prefix_cache_composes_with_speculation(seeds):
    w = seeds[0]
    p = list(range(30, 70))            # 40 tokens → 2 cacheable full blocks
    want = _gen(_jax(w), jds, [(p,)])[0].token_ids
    t = _port(w, dict(num_draft_tokens=3))
    first, second = _gen(t, tds, [(p,)])[0], _gen(t, tds, [(p,)])[0]
    assert second.cached_tokens >= 32
    assert first.token_ids == second.token_ids == want
    # the verify window counts in the one fit rule of admission and resume
    assert t._fits_empty_pool(16 * (t.num_blocks - 1) - 4)
    assert not t._fits_empty_pool(16 * (t.num_blocks - 1) - 3)


def test_failed_round_drops_draft_state_and_refuses_further_rounds(seeds, monkeypatch):
    w = seeds[0]
    t = _port(w, dict(num_draft_tokens=4))
    want = _gen(t, tds, [(PROMPTS[0],)])[0].token_ids
    assert t._spec_h is not None
    slot = t.submit(_req(tds, PROMPTS[0]))
    real = tspec.draft_apply
    calls = {"n": 0}

    def failing(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected draft failure")
        return real(*a, **kw)

    monkeypatch.setattr(tengine, "draft_apply", failing)
    with pytest.raises(RuntimeError, match="injected"):
        t.decode_multi(4)
    assert t._spec_h is None and not t._spec_h_zero
    with pytest.raises(tengine.EngineStateLost):
        t.spec_decode_step()
    t.finish_slot(slot, cache=False)
    monkeypatch.setattr(tengine, "draft_apply", real)
    # a rebuilt engine serves the request as before
    assert _gen(_port(w, dict(num_draft_tokens=4)), tds, [(PROMPTS[0],)])[0].token_ids == want
