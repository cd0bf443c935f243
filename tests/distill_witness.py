"""Held-out feature MSE of a distilled draft head, the JAX package's
``distill_draft_params`` beside the port's, on the CPU.

Both packages distil from the same start: one target drawn by JAX and
carried across with ``params_from_numpy``, JAX's own initial head carried
across with ``init_draft``, and one numpy ``data_stream`` (a fresh
generator of the same seed for each package). Each head is then scored as
the JAX test ``test_distilled_draft_beats_random`` scores it: the
next-hidden regression error on held-out random streams (4 x 64 tokens
from numpy seed 77), against the initial (random) head's, each package
with its own functions. The bound of that test is a ratio under 0.8.

The cells vary the vocabulary (2,048 as ``llama3-mini``, 128,256 as
``llama3-8b``) and the number of training positions (batch x (seq_len -
1) x num_batches) against the head's fused input width 2H, the other
candidate cause of a head that fits its streams and fails held-out ones:
llama3-8b's run distils 4,032 positions into a 2H = 8,192-wide input, a
ratio of 0.49. Widths are ``llama3-mini``'s (H = 256) at 2 layers.

Run from the repo root (a few minutes a large-vocabulary cell):

    JAX_PLATFORMS=cpu python tests/distill_witness.py [cell ...]

It prints one JSON line a cell."""

import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models.configs import (  # noqa: E402
    get_model_config as t_config,
)
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    draft_params_from_numpy,
    params_from_numpy,
)
from distributed_gpu_inference_torch.runtime import speculative as tspec  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.runtime import speculative as jspec  # noqa: E402

STEPS, SEQ = 400, 64
RATIO_BOUND = 0.8
# name: (vocab, batch, num_batches); positions = batch x 63 x num_batches
CELLS = {
    "v2048-4032pos": (2048, 8, 8),
    "v2048-252pos": (2048, 1, 4),
    "v128256-4032pos": (128256, 8, 8),
    "v128256-252pos": (128256, 1, 4),
}


def configs(vocab):
    jcfg = dataclasses.replace(get_model_config("llama3-mini", dtype="float32"),
                               vocab_size=vocab, num_layers=2)
    tcfg = dataclasses.replace(t_config("llama3-mini", dtype="float32"),
                               vocab_size=vocab, num_layers=2)
    return jcfg, tcfg


def stream(vocab):
    rng = np.random.default_rng(11)
    return lambda _key, b, s: rng.integers(0, vocab, (b, s), dtype=np.int32)


def jax_mse(cfg, params, head, toks):
    b, s = toks.shape
    m = -(-s // 16)
    h = jllama.forward_chunk(
        cfg, params, jnp.asarray(toks), jnp.tile(jnp.arange(s, dtype=jnp.int32), (b, 1)),
        jllama.init_kv_pools(cfg, 1 + b * m, 16, jnp.float32),
        jnp.arange(1, 1 + b * m, dtype=jnp.int32).reshape(b, m),
        jnp.full((b,), s, jnp.int32), block_size=16, last_only=False).hidden
    emb = jllama.embed_tokens(params, jnp.asarray(toks[:, 1:]), cfg)
    pred = jspec.draft_apply(cfg, jax.tree.map(lambda a: a.astype(jnp.float32), head),
                             h[:, :-1], emb)
    return float(jnp.mean(jnp.square(pred - h[:, 1:])))


def port_mse(cfg, params, head, toks):
    b, s = toks.shape
    m = -(-s // 16)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        h = tllama.forward_chunk(
            cfg, params, t, torch.arange(s, dtype=torch.int32).repeat(b, 1),
            tllama.init_kv_pools(cfg, 1 + b * m, 16, torch.float32, "cpu"),
            torch.arange(1, 1 + b * m, dtype=torch.int32).reshape(b, m),
            torch.full((b,), s, dtype=torch.int32), with_logits=False).hidden
        emb = tllama.embed_tokens(params, t[:, 1:], cfg)
        pred = tspec.draft_apply(cfg, {k: v.float() for k, v in head.items()}, h[:, :-1], emb)
        return float(torch.mean(torch.square(pred - h[:, 1:])))


def run_cell(name):
    vocab, batch, nb = CELLS[name]
    jcfg, tcfg = configs(vocab)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    key = jax.random.PRNGKey(2)
    kd, _ = jax.random.split(key)
    jinit = jax.tree.map(np.asarray, jspec.init_draft_params(jcfg, kd))
    kw = dict(steps=STEPS, batch=batch, seq_len=SEQ, num_batches=nb)
    t0 = time.perf_counter()
    jhead = jax.block_until_ready(jspec.distill_draft_params(
        jcfg, jparams, key, data_stream=stream(vocab), **kw))
    t1 = time.perf_counter()
    thead, losses = tspec.distill_draft_params(
        tcfg, tparams, 0, data_stream=stream(vocab),
        init_draft=draft_params_from_numpy(jinit, "cpu"), **kw)
    t2 = time.perf_counter()
    held = np.random.default_rng(77).integers(0, vocab, (4, SEQ), dtype=np.int32)
    j_d, j_r = jax_mse(jcfg, jparams, jhead, held), jax_mse(jcfg, jparams, jinit, held)
    tinit = draft_params_from_numpy(jinit, "cpu")
    t_d, t_r = port_mse(tcfg, tparams, thead, held), port_mse(tcfg, tparams, tinit, held)
    return {
        "cell": name, "vocab": vocab, "hidden": jcfg.hidden_size, "layers": jcfg.num_layers,
        "positions": batch * (SEQ - 1) * nb, "fused_input_width": 2 * jcfg.hidden_size,
        "steps": STEPS,
        "jax": {"distilled": j_d, "random": j_r, "ratio": j_d / j_r, "seconds": t1 - t0},
        "port": {"distilled": t_d, "random": t_r, "ratio": t_d / t_r, "seconds": t2 - t1,
                 "loss_first": float(losses[0]), "loss_last": float(losses[-1])},
        "ratio_bound": RATIO_BOUND,
    }


if __name__ == "__main__":
    for cell in sys.argv[1:] or list(CELLS):
        print(json.dumps(run_cell(cell)), flush=True)
