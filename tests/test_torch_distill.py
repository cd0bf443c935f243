"""Draft-head distillation in the port (``runtime/speculative.py``
``distill_draft_params``, ``TorchEngine.distill_draft`` and
``spec_distill_steps`` in ``TorchLLMEngine``) against the JAX package's
function on the CPU, ``llama3-tiny`` in f32, the same numpy-seeded target
weights on both sides:

- the teacher labels (final hiddens, top-64 log-probs and indices, tie
  order included) against JAX's ``forward_chunk`` + ``project_logits`` +
  ``lax.top_k``;
- the head after 10 steps, from JAX's own starting head (carried across
  with ``init_draft``) and one numpy ``data_stream``: every leaf within
  ``HEAD_ATOL`` of JAX's, and each head's loss, computed by the port,
  within ``LOSS_RTOL``; with and without EAGLE-3 ``feature_layers``;
- ``on_policy`` shapes and a falling loss, the model dtype on return, and
  a speculating ``TorchLLMEngine`` that distils at load and serves;
- the held-out feature MSE ratio of ``tests/distill_witness.py``'s
  cheapest cell (400 steps on fewer training positions than the head's
  fused input width): the port's within RATIO_RTOL of JAX's, and both
  above the JAX test's bound of 0.8.

Tolerances: both sides run the same f32 arithmetic in another order
(XLA's fused graph against eager torch), so the labels agree to ~1e-6
and ten Adam steps move a matrix leaf by ~lr·10 = 2e-2, each step's
direction set by gradients that agree to rounding; the two heads end
within 3e-5 of each other (measured), against HEAD_ATOL = 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models.configs import (  # noqa: E402
    get_model_config as t_config,
)
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    draft_params_from_numpy,
    params_from_numpy,
)
from distributed_gpu_inference_torch.runtime import speculative as tspec  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.base import EngineLoadError  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.llm import TorchLLMEngine  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import speculative as jspec  # noqa: E402

JCFG = get_model_config("llama3-tiny", dtype="float32")
TCFG = t_config("llama3-tiny", dtype="float32")
LABEL_ATOL = 1e-4
HEAD_ATOL = 1e-4
LOSS_RTOL = 1e-3
RATIO_RTOL = 5e-3        # 400 steps of f32 in two orders: 4.6e-4 measured
B, S, N = 2, 16, 2


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(JCFG, jax.random.PRNGKey(5), jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _stream():
    """One numpy data stream, fed to both packages: batches in call order
    (the key/generator argument is ignored)."""
    rng = np.random.default_rng(11)
    return lambda _key, b, s: rng.integers(0, JCFG.vocab_size, (b, s), dtype=np.int32)


def _port_loss(tparams, head, tokens, feature_layers=None):
    """The distillation loss of ``head`` on one batch, computed by the
    port: feature MSE + 0.2 x the teacher's top-64 CE."""
    n, b, s = tokens.shape
    with torch.no_grad():
        total = 0.0
        for i in range(n):
            toks = torch.from_numpy(tokens[i])
            m = -(-s // 16)
            out = tllama.forward_chunk(
                TCFG, tparams, toks, torch.arange(s, dtype=torch.int32).repeat(b, 1),
                tllama.init_kv_pools(TCFG, 1 + b * m, 16, torch.float32, "cpu"),
                torch.arange(1, 1 + b * m, dtype=torch.int32).reshape(b, m),
                torch.full((b,), s, dtype=torch.int32), with_logits=False,
                collect_layers=feature_layers)
            logp = torch.log_softmax(tllama.project_logits(TCFG, tparams, out.hidden), -1)
            top_lp, top_idx = tllama.sorted_top_k(logp, 64)
            feats = out.features if feature_layers else out.hidden
            pred = tspec.draft_apply(TCFG, {k: v.float() for k, v in head.items()},
                                     feats[:, :-1], tllama.embed_tokens(tparams, toks[:, 1:],
                                                                       TCFG))
            mse = torch.mean((pred - out.hidden[:, 1:]) ** 2)
            sel = torch.gather(torch.log_softmax(tllama.project_logits(TCFG, tparams, pred), -1),
                               -1, top_idx[:, 1:])
            ce = -torch.mean(torch.sum(torch.exp(top_lp[:, 1:]) * sel, -1))
            total += float(mse + 0.2 * ce)
    return total / n


def test_teacher_labels_match_jax(weights):
    jparams, tparams = weights
    toks = np.random.default_rng(3).integers(0, JCFG.vocab_size, (B, S), dtype=np.int32)
    # a planted tie: two vocabulary rows equal, so their logits tie exactly
    # everywhere and lax.top_k's order (lower index first) must be kept
    jparams = dict(jparams)
    jparams["embedding"] = jparams["embedding"].at[7].set(jparams["embedding"][300])
    tparams = dict(tparams)
    tparams["embedding"] = torch.from_numpy(np.array(jparams["embedding"]))

    @jax.jit
    def jteacher(p, t):
        kv = jllama.init_kv_pools(JCFG, 1 + B, 16)
        out = jllama.forward_chunk(
            JCFG, p, t, jnp.tile(jnp.arange(S, dtype=jnp.int32), (B, 1)), kv,
            jnp.arange(1, 1 + B, dtype=jnp.int32).reshape(B, 1),
            jnp.full((B,), S, jnp.int32), block_size=16, last_only=False)
        logp = jax.nn.log_softmax(jllama.project_logits(JCFG, p, out.hidden), -1)
        return out.hidden, jax.lax.top_k(logp, 64)

    jh, (jlp, jidx) = jax.tree.map(np.asarray, jteacher(jparams, jnp.asarray(toks)))
    out = tllama.forward_chunk(
        TCFG, tparams, torch.from_numpy(toks), torch.arange(S, dtype=torch.int32).repeat(B, 1),
        tllama.init_kv_pools(TCFG, 1 + B, 16, torch.float32, "cpu"),
        torch.arange(1, 1 + B, dtype=torch.int32).reshape(B, 1),
        torch.full((B,), S, dtype=torch.int32), with_logits=False)
    logp = torch.log_softmax(tllama.project_logits(TCFG, tparams, out.hidden), -1)
    tlp, tidx = tllama.sorted_top_k(logp, 64)
    np.testing.assert_allclose(out.hidden.numpy(), jh, atol=LABEL_ATOL)
    np.testing.assert_allclose(tlp.numpy(), jlp, atol=LABEL_ATOL)
    assert np.array_equal(tidx.numpy(), jidx)
    tie = np.argwhere((jidx == 7) | (jidx == 300))
    assert len(tie) > 0 and all(
        list(jidx[r, s]).index(7) < list(jidx[r, s]).index(300) for r, s, _ in tie
        if 7 in jidx[r, s] and 300 in jidx[r, s])


@pytest.mark.parametrize("feature_layers", [None, (0, 1)], ids=["last-layer", "eagle3"])
def test_distilled_head_matches_jax(weights, feature_layers):
    jparams, tparams = weights
    key = jax.random.PRNGKey(2)
    kd, _ = jax.random.split(key)
    nfl = len(feature_layers) if feature_layers else 1
    jinit = jax.tree.map(np.asarray, jspec.init_draft_params(JCFG, kd, num_feature_layers=nfl))
    kw = dict(steps=10, batch=B, seq_len=S, num_batches=N, feature_layers=feature_layers)
    jhead = jax.tree.map(np.asarray, jspec.distill_draft_params(
        JCFG, jparams, key, data_stream=_stream(), **kw))
    thead, losses = tspec.distill_draft_params(
        TCFG, tparams, 0, data_stream=_stream(),
        init_draft=draft_params_from_numpy(jinit, "cpu"), **kw)
    assert set(thead) == set(jhead)
    for k in jhead:
        np.testing.assert_allclose(thead[k].numpy(), jhead[k], atol=HEAD_ATOL, err_msg=k)
    # the matrices moved ~lr a step from where they started (100x the
    # tolerance), and both heads score alike
    assert all(np.abs(jhead[k] - jinit[k]).max() > 1e-2 for k in jhead if k != "norm")
    rng = np.random.default_rng(11)
    tokens = np.stack([rng.integers(0, JCFG.vocab_size, (B, S), dtype=np.int32)
                       for _ in range(N)])
    lt = _port_loss(tparams, thead, tokens, feature_layers)
    lj = _port_loss(tparams, draft_params_from_numpy(jhead, "cpu"), tokens, feature_layers)
    assert lt == pytest.approx(lj, rel=LOSS_RTOL)
    assert losses.shape == (10,) and float(losses[-1]) < float(losses[0])
    assert lt < _port_loss(tparams, draft_params_from_numpy(jinit, "cpu"), tokens,
                           feature_layers)


def test_on_policy_streams_and_a_falling_loss(weights):
    _, tparams = weights
    calls = []
    real = tllama.forward_chunk

    def spy(cfg, params, toks, *a, **kw):
        calls.append(tuple(toks.shape))
        return real(cfg, params, toks, *a, **kw)

    tllama.forward_chunk = spy
    try:
        head, losses = tspec.distill_draft_params(
            TCFG, tparams, torch.Generator().manual_seed(4), steps=40, batch=B, seq_len=S,
            num_batches=N, on_policy=True)
    finally:
        tllama.forward_chunk = real
    # each stream: S - 1 decode steps of one token a row, then the teacher
    assert calls == ([(B, 1)] * (S - 1) + [(B, S)]) * N
    assert {k: tuple(v.shape) for k, v in head.items()} == {
        "w_fuse": (128, 64), "w_out": (64, 64), "norm": (64,)}
    assert losses.shape == (40,) and all(np.isfinite(losses.numpy()))
    assert float(losses[-4:].mean()) < float(losses[:4].mean())


def test_distill_returns_model_dtype():
    cfg = t_config("llama3-tiny")                       # bfloat16
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    head, _ = tspec.distill_draft_params(cfg, params, 1, steps=3, batch=2, seq_len=16,
                                         num_batches=1)
    assert all(v.dtype == torch.bfloat16 for v in head.values())
    assert not any(v.requires_grad for v in params["layers"].values())


def test_engine_distills_at_load_and_serves(weights):
    _, tparams = weights
    base = dict(model="llama3-tiny", max_batch_size=2, max_seq_len=128, dtype="float32",
                device="cpu", params=tparams, speculative_decode=True,
                spec_num_draft_tokens=3, prefix_summary_top_n=0)
    llm = TorchLLMEngine(dict(base, spec_distill_steps=12))
    llm.load_model()
    plain = TorchLLMEngine(dict(base, speculative_decode=False))
    plain.load_model()
    try:
        assert llm.distill_losses.shape == (12,)
        random_head = tspec.init_draft_params(
            llm.engine.model_cfg, torch.Generator().manual_seed(1), dtype=torch.float32)
        assert any(not torch.equal(llm.engine._draft_params[k], random_head[k])
                   for k in random_head)
        req = {"prompt": "the quick brown fox", "max_new_tokens": 16, "ignore_eos": True}
        got, want = llm.inference(dict(req)), plain.inference(dict(req))
        # greedy output is the target's whatever the head drafts
        assert got["text"] == want["text"]
        assert got["usage"]["completion_tokens"] == 16
        assert llm.engine.get_stats()["spec_slot_steps"] > 0
    finally:
        llm.unload()
        plain.unload()


def test_engine_distill_needs_a_speculative_config(weights, monkeypatch):
    from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine

    eng = TorchEngine("llama3-tiny", EngineConfig(max_batch_size=1, max_seq_len=64,
                                                  dtype="float32"),
                      params=weights[1], device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        eng.distill_draft(steps=1)
    # without speculative_decode the key has nothing to distil: it loads plain
    llm = TorchLLMEngine(dict(model="llama3-tiny", max_batch_size=1, max_seq_len=64,
                              dtype="float32", device="cpu", spec_distill_steps=5))
    llm.load_model()
    assert llm.distill_losses is None
    llm.unload()

    def oom(self, steps, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(TorchEngine, "distill_draft", oom)
    failing = TorchLLMEngine(dict(model="llama3-tiny", max_batch_size=1, max_seq_len=64,
                                  dtype="float32", device="cpu", speculative_decode=True,
                                  spec_distill_steps=5, params=weights[1]))
    with pytest.raises(EngineLoadError, match="distillation failed: CUDA out of memory"):
        failing.load_model()
    assert failing.engine is None and failing.serving is None


def test_held_out_ratio_matches_jax_when_positions_are_few():
    import distill_witness

    r = distill_witness.run_cell("v2048-252pos")
    assert r["positions"] < r["fused_input_width"]
    assert r["port"]["ratio"] == pytest.approx(r["jax"]["ratio"], rel=RATIO_RTOL)
    # the head fits its 252 positions but gains nothing held-out, in both
    assert r["port"]["loss_last"] < 0.2 * r["port"]["loss_first"]
    assert min(r["jax"]["ratio"], r["port"]["ratio"]) > distill_witness.RATIO_BOUND
