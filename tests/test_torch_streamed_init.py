"""The port's streamed quantized init (``models/loader.py``
``init_quantized_streamed``) and the rule that picks it (``init_route``).

- The tree's layout (keys, shapes, dtypes) equals the JAX package's
  ``init_quantized_streamed`` for ``mixtral-tiny`` and ``llama3-tiny``, in
  int8 and fp8. The values differ (threefry there, a ``torch.Generator``
  here), as they differ between the two packages' ``init_params``.
- It is deterministic in the seed, and another seed draws other weights.
- Each leaf's codes and scales equal ``quantize_weight`` of its f32 layer
  slice drawn again from the leaf's generator (the seed and the crc32 of
  the leaf's name), also when the slice is quantized a few columns at a
  time.
- With the device's total memory patched below the full-precision tree, a
  quantized random init takes the streamed route (``load_or_init_params``
  and ``TorchEngine`` alike) and an unquantized one is refused with its
  size before anything is drawn; above it, the full init is kept.
"""

import zlib

import pytest

torch = pytest.importorskip("torch")

from distributed_gpu_inference_torch.models import llama as tllama  # noqa: E402
from distributed_gpu_inference_torch.models import loader as tloader  # noqa: E402
from distributed_gpu_inference_torch.models.configs import get_model_config as tget  # noqa: E402
from distributed_gpu_inference_torch.ops.quantization import quantize_weight  # noqa: E402
from distributed_gpu_inference_torch.runtime import engine as tengine  # noqa: E402
from distributed_gpu_inference_torch.utils import data_structures as tds  # noqa: E402
from distributed_gpu_inference_tpu.models import loader as jloader  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config as jget  # noqa: E402


def _layout(tree):
    """{path: (shape, dtype name)} of a JAX or a port tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
            return
        name = str(node.dtype).removeprefix("torch.")
        out[path] = (tuple(node.shape), name)

    walk(tree, "")
    return out


def _same(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8) if a.element_size() == 1
                                              else a, b.view(torch.uint8)
                                              if b.element_size() == 1 else b)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("model", ["mixtral-tiny", "llama3-tiny"])
def test_layout_equals_the_jax_streamed_init(model, mode):
    want = _layout(jloader.init_quantized_streamed(jget(model), mode, seed=0))
    got = _layout(tloader.init_quantized_streamed(tget(model), mode, seed=0, device="cpu"))
    assert got == want
    assert got["/embedding"][1] == "bfloat16"
    if model == "mixtral-tiny":
        assert got["/layers/w_router"] == ((2, 64, 4), "bfloat16")
        assert got["/layers/we_down/scale"] == ((2, 4, 1, 64), "float32")


def test_deterministic_in_the_seed():
    cfg = tget("mixtral-tiny")
    a = tloader.init_quantized_streamed(cfg, "int8", seed=0, device="cpu")
    b = tloader.init_quantized_streamed(cfg, "int8", seed=0, device="cpu")
    c = tloader.init_quantized_streamed(cfg, "int8", seed=1, device="cpu")
    assert _same(a, b)
    assert not torch.equal(a["layers"]["we_gate"]["qw"], c["layers"]["we_gate"]["qw"])
    assert not torch.equal(a["embedding"], c["embedding"])


def _redrawn(seed, name, shape, fan_in, layers):
    key = ((seed << 31) + (zlib.crc32(name.encode()) & 0x7FFFFFFF)) % (1 << 64)
    g = torch.Generator().manual_seed(key)
    return [torch.randn(shape, generator=g) * fan_in ** -0.5 for _ in range(layers)]


@pytest.mark.parametrize("chunk", [1 << 24, 100])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_each_leaf_is_quantize_weight_of_its_redrawn_slice(monkeypatch, mode, chunk):
    monkeypatch.setattr(tloader, "_QUANT_CHUNK", chunk)   # 100: one column a block
    cfg = tget("mixtral-tiny")
    h, i, e, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.num_layers
    d = cfg.head_dim
    tree = tloader.init_quantized_streamed(cfg, mode, seed=5, device="cpu")
    specs = {"wq": ((h, cfg.num_heads * d), h), "wk": ((h, cfg.num_kv_heads * d), h),
             "we_gate": ((e, h, i), h), "we_down": ((e, i, h), i)}
    for name, (shape, fan_in) in specs.items():
        leaf = tree["layers"][name]
        for layer, w in enumerate(_redrawn(5, name, shape, fan_in, L)):
            q = quantize_weight(w, mode)
            assert torch.equal(leaf["qw"][layer].view(torch.uint8),
                               q["qw"].view(torch.uint8)), (name, layer)
            assert torch.equal(leaf["scale"][layer], q["scale"]), (name, layer)
    g = torch.Generator().manual_seed(((5 << 31) + (zlib.crc32(b"w_router") & 0x7FFFFFFF)))
    router = (torch.randn((L, h, e), generator=g) * h ** -0.5).to(torch.bfloat16)
    assert torch.equal(tree["layers"]["w_router"], router)


def test_the_route_follows_the_device_total_memory(monkeypatch):
    cfg = tget("mixtral-tiny", dtype="float32")
    full = cfg.param_bytes(4)
    monkeypatch.setattr(tloader, "device_total_bytes", lambda device: full)
    assert tloader.init_route(cfg, "float32", "int8", "cpu") == "full"
    assert tloader.init_route(cfg, "float32", None, "cpu") == "full"
    monkeypatch.setattr(tloader, "device_total_bytes", lambda device: full - 1)
    assert tloader.init_route(cfg, "float32", "int8", "cpu") == "streamed"
    with pytest.raises(ValueError, match=r"mixtral-tiny.*GB, more than the device"):
        tloader.init_route(cfg, "float32", None, "cpu")
    # without a bound (the CPU) the full init is kept
    monkeypatch.undo()
    assert tloader.init_route(tget("mixtral-8x7b"), None, None, "cpu") == "full"


def test_load_and_engine_take_the_streamed_route_below_the_tree(monkeypatch):
    cfg = tget("mixtral-tiny", dtype="float32")
    monkeypatch.setattr(tloader, "device_total_bytes", lambda device: 1 << 20)

    def no_full_init(*a, **kw):
        raise AssertionError("the full-precision tree was drawn")

    monkeypatch.setattr(tllama, "init_params", no_full_init)
    want = tloader.init_quantized_streamed(cfg, "int8", "float32", seed=3, device="cpu")
    got = tloader.load_or_init_params(cfg, dtype="float32", seed=3, device="cpu",
                                      quantization="int8")
    assert _same(got, want)
    eng = tengine.TorchEngine(cfg, tengine.EngineConfig(
        max_batch_size=2, max_seq_len=64, prefill_buckets=(16,), dtype="float32",
        quantization="int8"), seed=3, device="cpu")
    assert _same(eng.params, want)
    out = eng.generate([tds.InferenceRequest(prompt_token_ids=list(range(5, 17)),
                                             sampling=tds.SamplingParams(max_new_tokens=6))])[0]
    assert len(out.token_ids) == 6 and all(0 <= t < cfg.vocab_size for t in out.token_ids)
    with pytest.raises(ValueError, match="more than the device"):
        tengine.TorchEngine(cfg, tengine.EngineConfig(
            max_batch_size=2, max_seq_len=64, dtype="float32"), seed=3, device="cpu")


def test_quantize_steps_stay_within_the_chunk(monkeypatch):
    """Each quantize step takes at most ``_QUANT_CHUNK`` f32 elements, so
    its temporaries stay that small beside the slice being quantized."""
    sizes = []
    real = tloader.quantize_weight

    def spy(w, mode):
        sizes.append(w.numel())
        return real(w, mode)

    monkeypatch.setattr(tloader, "quantize_weight", spy)
    monkeypatch.setattr(tloader, "_QUANT_CHUNK", 64 * 8)
    tloader.init_quantized_streamed(tget("mixtral-tiny"), "int8", seed=0, device="cpu")
    assert max(sizes) <= 64 * 8 and len(sizes) > 100
