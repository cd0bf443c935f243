"""The port's in-mesh stage pipeline (``parallel/pipeline.py``
``shard_params_stages`` / ``shard_kv_stages`` / ``pipelined_forward``, stage
ranks spawned by ``runtime/tp.py`` ``run_group`` and joined over gloo on the
CPU) against the JAX package's whole-model ``llama.forward_chunk`` on the
same numpy-seeded weights, f32, a 4-layer ``llama3-tiny``:

- 2 and 4 stages, a prefill of 3 microbatches x 2 rows x 16 tokens (one row
  shorter, padded), then one decode tick: the last stage's logits within
  ``atol 1e-5`` of JAX's, every stage's pools equal to its layers of the
  JAX pools (and bit for bit to the port's one-rank ``forward_chunk``);
- int8 weights (qmm's plain version on the CPU) against the port's one-rank
  ``forward_chunk`` on the same quantized tree;
- the uneven-split refusal, on the ranks and in the helpers.

JAX's own ``pipelined_forward`` test is marked slow and is not run here."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_gpu_inference_torch.models import configs as tconfigs  # noqa: E402
from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models.convert import params_from_numpy  # noqa: E402
from distributed_gpu_inference_torch.ops.quantization import quantize_params  # noqa: E402
from distributed_gpu_inference_torch.parallel import pipeline as tpipe  # noqa: E402
from distributed_gpu_inference_torch.runtime import tp as tp_ranks  # noqa: E402
from distributed_gpu_inference_tpu.models import configs as jconfigs  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402

L, BS, N_MICRO, MB, S, BLOCKS = 4, 8, 3, 2, 16, 40
TIMEOUT = dict(timeout_s=60.0)


def _cfgs():
    t = dataclasses.replace(tconfigs.get_model_config("llama3-tiny"), num_layers=L)
    j = dataclasses.replace(jconfigs.get_model_config("llama3-tiny"), num_layers=L)
    return t, j


@pytest.fixture(scope="module")
def weights():
    _, jcfg = _cfgs()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _inputs():
    """Prefill and decode-tick arrays [n_micro, mb, .]: microbatch m's row r
    owns blocks 1 + 3·(2m + r) .. (3 blocks of 8 tokens); row 1 of each
    microbatch is 5 tokens shorter (padded with -1)."""
    rng = np.random.default_rng(11)
    toks = rng.integers(1, 500, (N_MICRO, MB, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (N_MICRO, MB, 1))
    pos[:, 1, S - 5:] = -1
    lens = (pos >= 0).sum(-1).astype(np.int32)
    tables = (1 + 3 * np.arange(N_MICRO * MB, dtype=np.int32)[:, None]
              + np.arange(3, dtype=np.int32)[None, :]).reshape(N_MICRO, MB, 3)
    dec_toks = rng.integers(1, 500, (N_MICRO, MB, 1)).astype(np.int32)
    dec_pos = lens[..., None].copy()
    return (toks, pos, lens, tables), (dec_toks, dec_pos, lens + 1, tables)


def _pipeline_rank(group, np_params, quant, steps):
    """One stage rank: the whole tree built from numpy, cut to this stage,
    then each step's pipelined forward → (per-step logits, this stage's
    pools)."""
    torch.set_num_threads(1)
    tcfg, _ = _cfgs()
    params = quantize_params(params_from_numpy(np_params, "cpu"), quant)
    n, s = group.size, group.rank
    stage = tpipe.shard_params_stages(params, s, n)
    kv = tpipe.shard_kv_stages(
        tllama.init_kv_pools(tcfg, BLOCKS, BS, torch.float32, "cpu"), s, n)
    logits = []
    for toks, pos, lens, tables in steps:
        out, kv = tpipe.pipelined_forward(
            tcfg, stage, torch.tensor(toks), torch.tensor(pos), kv, torch.tensor(tables),
            torch.tensor(lens), group, block_size=BS)
        logits.append(out.numpy())
    return logits, {k: v.numpy().copy() for k, v in kv.items()}


def _port_reference(np_params, quant, steps):
    """The port's one-rank forward_chunk, microbatch by microbatch."""
    tcfg, _ = _cfgs()
    params = quantize_params(params_from_numpy(np_params, "cpu"), quant)
    kv = tllama.init_kv_pools(tcfg, BLOCKS, BS, torch.float32, "cpu")
    logits = []
    for toks, pos, lens, tables in steps:
        step = []
        for m in range(N_MICRO):
            out = tllama.forward_chunk(tcfg, params, torch.tensor(toks[m]),
                                       torch.tensor(pos[m]), kv, torch.tensor(tables[m]),
                                       torch.tensor(lens[m]), block_size=BS)
            step.append(out.logits[:, 0].numpy())
        logits.append(np.stack(step))
    return logits, {k: v.numpy() for k, v in kv.items()}


def _jax_reference(jparams, steps):
    _, jcfg = _cfgs()
    kv = jllama.init_kv_pools(jcfg, BLOCKS, BS, jnp.float32)
    fwd = jax.jit(lambda p, t, q, c, b, n: jllama.forward_chunk(
        jcfg, p, t, q, c, b, n, block_size=BS))
    logits = []
    for toks, pos, lens, tables in steps:
        step = []
        for m in range(N_MICRO):
            out = fwd(jparams, jnp.asarray(toks[m]), jnp.asarray(pos[m]), kv,
                      jnp.asarray(tables[m]), jnp.asarray(lens[m]))
            kv = out.kv
            step.append(np.asarray(out.logits[:, 0]))
        logits.append(np.stack(step))
    return logits, {k: np.asarray(v) for k, v in kv.items()}


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipelined_forward_matches_jax_forward_chunk(weights, n_stages):
    jp, np_params = weights
    steps = list(_inputs())
    outs = tp_ranks.run_group(_pipeline_rank, ["cpu"] * n_stages, np_params, None, steps,
                              **TIMEOUT)
    jlogits, jkv = _jax_reference(jp, steps)
    plogits, pkv = _port_reference(np_params, None, steps)
    per = L // n_stages
    for logits, _ in outs:          # the last stage's logits, broadcast to every rank
        for got, want, own in zip(logits, jlogits, plogits):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            np.testing.assert_array_equal(got, own)
    for s, (_, kv) in enumerate(outs):
        for k in ("k", "v"):
            np.testing.assert_allclose(kv[k], jkv[k][s * per:(s + 1) * per], atol=1e-5,
                                       rtol=0)
            np.testing.assert_array_equal(kv[k], pkv[k][s * per:(s + 1) * per])
    # the pad rows and the blocks no row owns were written by no tick
    assert not any(np.any(kv["k"][:, 3 * N_MICRO * MB + 1:]) for _, kv in outs)


def test_pipelined_forward_on_int8_weights(weights):
    _, np_params = weights
    steps = list(_inputs())
    outs = tp_ranks.run_group(_pipeline_rank, ["cpu"] * 2, np_params, "int8", steps,
                              **TIMEOUT)
    plogits, pkv = _port_reference(np_params, "int8", steps)
    for got, want in zip(outs[0][0], plogits):
        np.testing.assert_array_equal(got, want)
    for s, (_, kv) in enumerate(outs):
        np.testing.assert_array_equal(kv["k"], pkv["k"][s * 2:(s + 1) * 2])


def _uneven_rank(group, np_params):
    tcfg, _ = _cfgs()
    cfg3 = dataclasses.replace(tcfg, num_layers=3)
    params = params_from_numpy(np_params, "cpu")
    kv = tllama.init_kv_pools(cfg3, 4, BS, torch.float32, "cpu")
    z = torch.zeros((1, 1, 1), dtype=torch.int32)
    try:
        tpipe.pipelined_forward(cfg3, params, z, z, kv, z, z[..., 0], group, block_size=BS)
    except ValueError as exc:
        return str(exc)
    return None


def test_uneven_split_is_refused(weights):
    _, np_params = weights
    msgs = tp_ranks.run_group(_uneven_rank, ["cpu"] * 2, np_params, **TIMEOUT)
    assert msgs == ["3 layers not divisible by 2 stages; use the cross-host planner "
                    "(create_shard_plan) for uneven splits"] * 2
    tcfg, _ = _cfgs()
    params = params_from_numpy(np_params, "cpu")
    with pytest.raises(ValueError, match="4 layers not divisible by 3 stages"):
        tpipe.shard_params_stages(params, 0, 3)
    kv = tllama.init_kv_pools(tcfg, 4, BS, torch.float32, "cpu")
    with pytest.raises(ValueError, match="4 layers not divisible by 3 stages"):
        tpipe.shard_kv_stages(kv, 0, 3)
    # the whole model as one stage is the one-rank forward
    stage = tpipe.shard_params_stages(params, 0, 1)
    assert stage["layers"]["wq"].data_ptr() == params["layers"]["wq"].data_ptr()
