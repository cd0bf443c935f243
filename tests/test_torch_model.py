"""The port's ``forward_chunk`` against the JAX package's on the four
``*-tiny`` dense configs in f32 (CPU, plain attention on both sides): a
fresh prefill, a chunked prefill over the cached prefix, and an S=1 decode
step (the port's fused decode op in its plain form), with an inactive pad
row throughout. Logits agree within atol 1e-4 (summation order differs),
argmax is identical, and the KV pools agree after every step."""

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
    kv_from_numpy,
    params_from_numpy,
)
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402

BS = 16
M = 4              # table width: 64 positions per row


def _rows(spans, width):
    """(tokens, positions) [B, width] for rows that each continue their
    context at ``off`` with ``n`` fresh tokens (n = 0 → pad row)."""
    rng = np.random.default_rng(len(spans) * 100 + width)
    b = len(spans)
    toks = rng.integers(0, 512, (b, width)).astype(np.int32)
    pos = np.full((b, width), -1, np.int32)
    for i, (off, n) in enumerate(spans):
        pos[i, :n] = np.arange(off, off + n)
    return toks, pos


def _both(cfg_name):
    jcfg = get_model_config(cfg_name, dtype="float32")
    tcfg = tget(cfg_name, dtype="float32")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jkv = jllama.init_kv_pools(jcfg, 1 + 3 * M, BS, jnp.float32)
    tkv = kv_from_numpy(jax.tree.map(np.asarray, jkv), "cpu")
    return jcfg, tcfg, jparams, tparams, jkv, tkv


@pytest.mark.parametrize(
    "name", ["llama3-tiny", "qwen2.5-tiny", "mistral-tiny", "gemma-tiny"])
def test_forward_chunk_matches_jax(name):
    jcfg, tcfg, jparams, tparams, jkv, tkv = _both(name)
    tables = np.arange(1, 1 + 3 * M, dtype=np.int32).reshape(3, M)
    tables[2] = 0                                   # inactive row: pad block
    steps = [
        # (spans per row, width, last_only): fresh prefill of 12 and 16
        ([(0, 12), (0, 16), (0, 0)], 16, False),
        # chunked prefill over the cached prefix (crosses mistral's window)
        ([(12, 16), (16, 8), (0, 0)], 16, True),
        # decode: one query per row at the context tail
        ([(28, 1), (24, 1), (0, 0)], 1, True),
    ]
    for spans, width, last_only in steps:
        toks, pos = _rows(spans, width)
        lens = np.array([off + n for off, n in spans], np.int32)
        jout = jllama.forward_chunk(
            jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos), jkv,
            jnp.asarray(tables), jnp.asarray(lens), block_size=BS,
            last_only=last_only,
        )
        jkv = jout.kv
        tout = tllama.forward_chunk(
            tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(pos), tkv,
            torch.from_numpy(tables), torch.from_numpy(lens), block_size=BS,
            last_only=last_only,
        )
        want = np.asarray(jout.logits)
        got = tout.logits.numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        live = pos >= 0 if not last_only else np.ones(want.shape[:2], bool)
        np.testing.assert_array_equal(got.argmax(-1)[live], want.argmax(-1)[live])
        for k in ("k", "v"):
            np.testing.assert_allclose(tkv[k].numpy(), np.asarray(jkv[k]),
                                       atol=1e-5, rtol=0)
    # the pad block and the inactive row's pages were never written
    assert not tkv["k"][:, 0].any() and not tkv["v"][:, 0].any()


def test_moe_and_quantized_weights_raise():
    cfg = tget("mixtral-tiny", dtype="float32")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        tllama.init_params(cfg, gen, torch.float32, "cpu")
    # MoE still raises; a quantized weight leaf is served now and gives the
    # forward of its dequantized weight (f32: the same products, exact
    # code conversion; 1e-5 covers the summation order)
    from distributed_gpu_inference_torch.ops.quantization import dequantize, quantize_weight

    dense = tget("llama3-tiny", dtype="float32")
    params = tllama.init_params(dense, gen, torch.float32, "cpu")
    q = quantize_weight(params["layers"]["wq"], "int8")
    deq = dict(params, layers=dict(params["layers"], wq=dequantize(q)))
    params["layers"]["wq"] = q
    z = torch.zeros((1, 1), dtype=torch.int32)
    outs = [tllama.forward_chunk(dense, p, z, z,
                                 tllama.init_kv_pools(dense, 5, BS, torch.float32, "cpu"),
                                 torch.ones((1, 1), dtype=torch.int32),
                                 torch.ones(1, dtype=torch.int32)).logits
            for p in (params, deq)]
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)
