"""Weight-only quantization in the PyTorch port against the JAX package.

- ``quantize_weight`` / ``quantize_params``: int8 and fp8 codes and scales
  BIT-IDENTICAL to JAX's for the same float32 (and bf16) weights, and the
  fp8 cast (``to_float8_e4m3``) bit-identical to ``astype(float8_e4m3fn)``
  over every bf16 value, overflow to NaN included.
- The quantized matmul's plain version (what ``qmm_w8a16`` runs on a CPU
  tensor) against the Pallas ``qmm_stacked_pallas`` in interpret mode and
  against the JAX package's XLA route (``quantization.matmul``): rows,
  layer-index selection, several K stages, fp8 storage. Tolerances: f32
  activations 1e-5 (only the summation order differs); bf16 activations
  one bf16 rounding of the output, atol 2e-3 + rtol 1e-2 against Pallas
  (both round once) and 2e-2 against the XLA route, which rounds the
  product to bf16 before it scales.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    array_to_tensor,
    params_from_numpy,
    params_to_numpy,
    tensor_to_words,
)
from distributed_gpu_inference_torch.ops import qmm as tqmm  # noqa: E402
from distributed_gpu_inference_torch.ops import quantization as tq  # noqa: E402
from distributed_gpu_inference_tpu.models import llama as jllama  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config  # noqa: E402
from distributed_gpu_inference_tpu.ops import quantization as jq  # noqa: E402
from distributed_gpu_inference_tpu.ops.qmm_pallas import qmm_stacked_pallas  # noqa: E402


def _bits(a):
    """Raw bits of a numpy/JAX array or a tensor, as unsigned words."""
    a = tensor_to_words(a) if torch.is_tensor(a) else np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _weights(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 3] = 0.0                                   # an all-zero channel: scale 1
    w[..., 5] *= 40.0                                 # a wide channel
    return w if dtype == np.float32 else w.astype(dtype)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(64, 48), (3, 128, 96)])
def test_quantize_weight_bit_identical(mode, shape, wdtype):
    w = _weights(shape, 0, ml_dtypes.bfloat16 if wdtype == "bfloat16" else np.float32)
    want = jq.quantize_weight(jnp.asarray(w), mode)
    got = tq.quantize_weight(array_to_tensor(w, "cpu"), mode)
    assert got["qw"].dtype == (torch.int8 if mode == "int8" else torch.float8_e4m3fn)
    assert tuple(got["scale"].shape) == tuple(want["scale"].shape)
    np.testing.assert_array_equal(_bits(got["qw"]), _bits(want["qw"]))
    np.testing.assert_array_equal(_bits(got["scale"]), _bits(want["scale"]))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_params_bit_identical_and_consume(mode):
    cfg = get_model_config("llama3-tiny", dtype="float32")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    want = jax.tree.map(np.asarray, jq.quantize_params(jparams, mode))
    src = params_from_numpy(tree, "cpu")
    kept = tq.quantize_params(src, mode)                      # caller's tree untouched
    assert all(torch.is_tensor(v) for v in src["layers"].values())
    got = tq.quantize_params(src, mode, consume=True)
    assert src["layers"] == {}                                 # consumed leaf by leaf
    for tree_got in (kept, got):
        words = params_to_numpy(tree_got)
        for name, leaf in want["layers"].items():
            if isinstance(leaf, dict):
                assert name in jq.QUANT_KEYS and tq.is_quantized(tree_got["layers"][name])
                for part in ("qw", "scale"):
                    np.testing.assert_array_equal(_bits(words["layers"][name][part]),
                                                  _bits(leaf[part]), err_msg=name)
            else:
                np.testing.assert_array_equal(_bits(words["layers"][name]), _bits(leaf),
                                              err_msg=name)
    # a JAX-quantized tree crosses the bridge bit for bit
    bridged = params_from_numpy(want, "cpu")
    assert bridged["layers"]["wq"]["qw"].dtype == got["layers"]["wq"]["qw"].dtype
    np.testing.assert_array_equal(tensor_to_words(bridged["layers"]["w_up"]["qw"]),
                                  tensor_to_words(got["layers"]["w_up"]["qw"]))


def test_fp8_cast_matches_astype_on_every_bf16_value():
    words = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    vals = words.view(ml_dtypes.bfloat16)
    want = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = tensor_to_words(tq.to_float8_e4m3(array_to_tensor(vals, "cpu")))
    np.testing.assert_array_equal(got, want)
    # f32 inputs near and past the range: 464 rounds to 448, above is NaN
    f = np.array([447.9, 448.0, 463.9, 464.0, 464.1, 479.0, 1e6, -464.1, np.inf,
                  -np.inf, 1e-9, -2.5e-3], np.float32)
    want = np.asarray(jnp.asarray(f).astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(tensor_to_words(tq.to_float8_e4m3(torch.from_numpy(f))),
                                  want)


def _stacked(l, k, n, mode, seed):
    w = _weights((l, k, n), seed)
    j = jq.quantize_weight(jnp.asarray(w), mode)
    t = tq.quantize_weight(torch.from_numpy(w), mode)
    return j, t


def _x(m, k, dtype, seed):
    x = (np.random.default_rng(seed).standard_normal((m, k)) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    return x


def _close(got, want, dtype, pallas=True):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    elif pallas:
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-2)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("m", [1, 16, 32, 100])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_qmm_plain_matches_pallas_and_xla_rows(m, dtype):
    j, t = _stacked(1, 256, 256, "int8", 0)
    x = _x(m, 256, dtype, 1)
    tx = array_to_tensor(x, "cpu")
    got = tqmm.qmm_w8a16(tx, t["qw"], t["scale"])
    assert got.shape == (m, 256) and got.dtype == tx.dtype
    _close(got, qmm_stacked_pallas(jnp.asarray(x), j["qw"], j["scale"], jnp.int32(0),
                                   interpret=True), dtype)
    _close(got, jq.matmul(jnp.asarray(x), {"qw": j["qw"][0], "scale": j["scale"][0]}),
           dtype, pallas=False)


def test_qmm_layer_index_selects_layer():
    j, t = _stacked(3, 128, 128, "int8", 2)
    x = _x(16, 128, "bfloat16", 3)
    for idx in range(3):
        got = tqmm.qmm_w8a16(array_to_tensor(x, "cpu"), t["qw"], t["scale"], idx)
        _close(got, qmm_stacked_pallas(jnp.asarray(x), j["qw"], j["scale"], jnp.int32(idx),
                                       interpret=True), "bfloat16")
        # one layer's views through the model's dispatch give the same
        view = {"qw": t["qw"][idx], "scale": t["scale"][idx]}
        assert torch.equal(tq.matmul(array_to_tensor(x, "cpu"), view), got)


def test_qmm_multi_k_stages_accumulate():
    j, t = _stacked(1, 2560, 128, "int8", 4)
    x = _x(8, 2560, "bfloat16", 5)
    got = tqmm.qmm_w8a16(array_to_tensor(x, "cpu"), t["qw"], t["scale"])
    _close(got, qmm_stacked_pallas(jnp.asarray(x), j["qw"], j["scale"], jnp.int32(0),
                                   interpret=True), "bfloat16")
    # the kernel's split plan covers K with whole 64-row stages
    for m, k, n in ((8, 4096, 1024), (8, 14336, 4096), (64, 4096, 14336), (8, 2560, 128)):
        splits, per = tqmm.split_plan(m, k, n)
        assert per % 64 == 0 and splits * per >= k > (splits - 1) * per


# the kernel's default geometry and two others of its sweep (stages, K rows
# a stage, columns a block)
_GEOMETRIES = [tqmm.GEOMETRY, (2, 128, 128), (8, 64, 128)]


@pytest.mark.parametrize("geometry", _GEOMETRIES)
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                                 (1408, 128), (4112, 1024), (208, 48), (16, 16)])
@pytest.mark.parametrize("m", [1, 8, 40, 128])
def test_split_plan_covers_k_once_and_fills_the_ring(m, k, n, geometry):
    stages, rows, cols = geometry
    splits, per = tqmm.split_plan(m, k, n, geometry)
    assert tqmm.split_plan(m, k, n, geometry) == (splits, per)     # a pure function
    # whole stages, no split empty, K covered exactly once
    assert per % rows == 0 and splits * per >= k > (splits - 1) * per
    spans = [min(k, (s + 1) * per) - s * per for s in range(splits)]
    assert sum(spans) == k and min(spans) > 0
    # every split, the last one included, holds a full ring where K allows
    if -(-k // rows) >= stages:
        assert all(-(-span // rows) >= stages for span in spans)
    # more splits only where the grid is short of its target and the ring allows
    tiles = -(-n // cols) * -(-m // tqmm.row_group(m))
    if splits > 1:
        assert (splits - 1) * tiles < tqmm.TARGET_BLOCKS


def _split_reduce(x, qw, scale, layer=0, geometry=tqmm.GEOMETRY):
    """The kernel's order of summation in plain PyTorch: each split of the
    plan sums its K rows in f32, the splits are added in split order, the
    scale applied once and the sum rounded once."""
    m, k = x.shape
    splits, per = tqmm.split_plan(m, k, qw.shape[-1], geometry)
    total = None
    for s in range(splits):
        part = x[:, s * per:(s + 1) * per].float() @ qw[layer, s * per:(s + 1) * per].float()
        total = part if total is None else total + part
    return (total * scale[layer].float()).to(x.dtype)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("geometry", _GEOMETRIES)
def test_split_reduce_order_matches_plain_and_pallas(mode, geometry):
    # K = 1408 is 22 stages of 64: the default plan takes 4 splits of 6, 6,
    # 6 and 4 stages (a short last split)
    k, n, m = 1408, 128, 8
    j, t = _stacked(2, k, n, mode, 10)
    x = _x(m, k, "bfloat16", 11)
    splits, per = tqmm.split_plan(m, k, n, geometry)
    assert splits > 1
    if geometry == tqmm.GEOMETRY:
        assert (splits, per) == (4, 384)
    tx = array_to_tensor(x, "cpu")
    got = _split_reduce(tx, t["qw"], t["scale"], 1, geometry)
    _close(got, tqmm.qmm_plain(tx, t["qw"], t["scale"], 1).float(), "bfloat16")
    _close(got, qmm_stacked_pallas(jnp.asarray(x), j["qw"], j["scale"], jnp.int32(1),
                                   interpret=True), "bfloat16")


def test_qmm_fp8_storage():
    j, t = _stacked(1, 128, 128, "fp8", 6)
    x = _x(16, 128, "bfloat16", 7)
    got = tqmm.qmm_w8a16(array_to_tensor(x, "cpu"), t["qw"], t["scale"])
    _close(got, qmm_stacked_pallas(jnp.asarray(x), j["qw"], j["scale"], jnp.int32(0),
                                   interpret=True), "bfloat16")
    _close(got, jq.matmul(jnp.asarray(x), {"qw": j["qw"][0], "scale": j["scale"][0]}),
           "bfloat16", pallas=False)


def test_matmul_dispatch_keeps_leading_axes():
    j, t = _stacked(1, 64, 48, "int8", 8)
    x = (np.random.default_rng(9).standard_normal((3, 5, 64))).astype(np.float32)
    view = {"qw": t["qw"][0], "scale": t["scale"][0]}
    got = tq.matmul(torch.from_numpy(x), view)
    want = jq.matmul(jnp.asarray(x), {"qw": j["qw"][0], "scale": j["scale"][0]})
    assert tuple(got.shape) == (3, 5, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    plain = torch.randn(64, 48)
    assert torch.equal(tq.matmul(torch.from_numpy(x), plain), torch.from_numpy(x) @ plain)
    np.testing.assert_allclose(tq.dequantize(view).numpy(),
                               np.asarray(jq.dequantize({"qw": j["qw"][0],
                                                         "scale": j["scale"][0]})),
                               rtol=0, atol=0)
