"""HF checkpoints in the PyTorch port (``models/loader.py``) against the JAX
package's ``models/loader.py``.

The same numpy-seeded tensors, written with ``safetensors``, load through
JAX ``load_hf_llama`` and the port's; the port's tree (raw bits through
``params_to_numpy``) must be bit-identical, for llama3-tiny in one and two
shards, qwen2.5-tiny (biases, tied head), gemma-tiny, mixtral-tiny's expert
names, first / middle / last pipeline stages with a tied head, and an f32
checkpoint cast to bf16. Quantize-on-load (int8, fp8) must equal JAX
``quantize_params`` of the full-precision tree bit for bit, ``_validate``
must refuse with JAX's messages, a missing layer tensor loads as zeros in
both (a reference fault the port mirrors), and an orbax directory is
refused by name."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
st_torch = pytest.importorskip("safetensors.torch")


from distributed_gpu_inference_torch.models import loader as tloader  # noqa: E402
from distributed_gpu_inference_torch.models.configs import get_model_config as tcfg  # noqa: E402
from distributed_gpu_inference_torch.models.convert import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
    tensor_to_words,
)
from distributed_gpu_inference_torch.ops import quantization as tq  # noqa: E402
from distributed_gpu_inference_torch.runtime.engine import EngineConfig, TorchEngine  # noqa: E402
from distributed_gpu_inference_torch.utils.data_structures import BlockRange  # noqa: E402
from distributed_gpu_inference_tpu.models import loader as jloader  # noqa: E402
from distributed_gpu_inference_tpu.models.configs import get_model_config as jcfg  # noqa: E402
from distributed_gpu_inference_tpu.ops import quantization as jq  # noqa: E402
from distributed_gpu_inference_tpu.utils.data_structures import BlockRange as JBlockRange  # noqa: E402


def hf_tensors(cfg, seed=0, dtype=torch.bfloat16):
    """An HF checkpoint of ``cfg`` (HF names, ``[out, in]``) drawn from a
    numpy seed: {name: tensor}. Mixtral configs get the expert names."""
    rng = np.random.default_rng(seed)
    h, d, L = cfg.hidden_size, cfg.head_dim, cfg.num_layers
    nh, nkv, i, v = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    shapes = {"model.embed_tokens.weight": (v, h), "model.norm.weight": (h,)}
    if not cfg.tie_word_embeddings:
        shapes["lm_head.weight"] = (v, h)
    for li in range(L):
        p = f"model.layers.{li}."
        shapes.update({
            p + "input_layernorm.weight": (h,), p + "post_attention_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (nh * d, h),
            p + "self_attn.k_proj.weight": (nkv * d, h),
            p + "self_attn.v_proj.weight": (nkv * d, h),
            p + "self_attn.o_proj.weight": (h, nh * d)})
        if cfg.attention_bias:
            shapes.update({p + "self_attn.q_proj.bias": (nh * d,),
                           p + "self_attn.k_proj.bias": (nkv * d,),
                           p + "self_attn.v_proj.bias": (nkv * d,)})
        if cfg.num_experts:
            shapes[p + "block_sparse_moe.gate.weight"] = (cfg.num_experts, h)
            for e in range(cfg.num_experts):
                q = f"{p}block_sparse_moe.experts.{e}."
                shapes.update({q + "w1.weight": (i, h), q + "w3.weight": (i, h),
                               q + "w2.weight": (h, i)})
        else:
            shapes.update({p + "mlp.gate_proj.weight": (i, h), p + "mlp.up_proj.weight": (i, h),
                           p + "mlp.down_proj.weight": (h, i)})
    out = {}
    for name, shape in shapes.items():
        w = rng.standard_normal(shape).astype(np.float32) * (shape[-1] ** -0.5)
        if len(shape) == 1:
            w = 1.0 + 0.1 * w
        out[name] = torch.from_numpy(w).to(dtype)
    return out


def write_checkpoint(d, tensors, shards=1):
    """``tensors`` as ``shards`` safetensors files (names spread round-robin,
    so a layer's tensors land in different files) plus a config.json."""
    d.mkdir(parents=True, exist_ok=True)
    names = sorted(tensors)
    for k in range(shards):
        part = {n: tensors[n] for n in names[k::shards]}
        st_torch.save_file(part, str(d / f"model-{k + 1:05d}-of-{shards:05d}.safetensors"),
                           metadata={"format": "pt"})
    (d / "config.json").write_text("{}")
    return d


def _words(a):
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])
    return a


def assert_same_tree(jtree, ttree, path=""):
    """The JAX tree (arrays) and the port's (tensors) bit for bit."""
    assert set(jtree) == set(ttree), (path, sorted(jtree), sorted(ttree))
    for k in jtree:
        if isinstance(jtree[k], dict):
            assert_same_tree(jtree[k], ttree[k], f"{path}/{k}")
            continue
        want = _words(jtree[k])
        got = _words(tensor_to_words(ttree[k]) if torch.is_tensor(ttree[k]) else ttree[k])
        assert got.shape == want.shape, (f"{path}/{k}", got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("model,shards,dtype", [
    ("llama3-tiny", 1, torch.bfloat16),
    ("llama3-tiny", 2, torch.bfloat16),
    ("qwen2.5-tiny", 1, torch.bfloat16),
    ("gemma-tiny", 2, torch.bfloat16),
    ("mixtral-tiny", 2, torch.bfloat16),
    ("llama3-tiny", 1, torch.float32),     # an f32 checkpoint cast to bf16
])
def test_tree_bit_identical_to_jax_loader(tmp_path, model, shards, dtype):
    d = write_checkpoint(tmp_path / "ckpt", hf_tensors(tcfg(model), seed=1, dtype=dtype), shards)
    want = jloader.load_hf_llama(d, jcfg(model))
    got = tloader.load_hf_llama(d, tcfg(model), device="cpu")
    assert got["layers"]["wq"].dtype == torch.bfloat16
    assert_same_tree(want, got)
    if tcfg(model).num_experts:
        assert got["layers"]["we_gate"].shape == (2, 4, 64, 128)
        assert got["layers"]["w_router"].shape == (2, 64, 4)


@pytest.mark.parametrize("stage", [(0, 1), (1, 2), (2, 3)], ids=["first", "middle", "last"])
def test_pipeline_stages_with_a_tied_head(tmp_path, stage):
    cfg_t, cfg_j = tcfg("qwen2.5-tiny", num_layers=3), jcfg("qwen2.5-tiny", num_layers=3)
    d = write_checkpoint(tmp_path / "ckpt", hf_tensors(cfg_t, seed=2), shards=3)
    want = jloader.load_hf_llama(d, cfg_j, layer_range=JBlockRange(*stage))
    got = tloader.load_hf_llama(d, cfg_t, layer_range=BlockRange(*stage), device="cpu")
    assert_same_tree(want, got)
    # the embedding on the first stage, and on the last for the tied head
    assert ("embedding" in got) == (stage != (1, 2))
    assert ("final_norm" in got) == (stage == (2, 3))
    assert got["layers"]["wq"].shape[0] == 1


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("model", ["llama3-tiny", "qwen2.5-tiny"])
def test_quantize_on_load_bit_identical_to_jax_quantize_params(tmp_path, mode, model):
    d = write_checkpoint(tmp_path / "ckpt", hf_tensors(tcfg(model), seed=3), shards=2)
    want = jq.quantize_params(jloader.load_hf_llama(d, jcfg(model)), mode)
    got = tloader.load_hf_llama(d, tcfg(model), device="cpu", quantization=mode)
    assert tq.is_quantized(got["layers"]["w_up"])
    assert_same_tree(want, got)
    # and equal to the port's own quantize_params of its bf16 tree
    full = tloader.load_hf_llama(d, tcfg(model), device="cpu")
    assert_same_tree(params_to_numpy(tq.quantize_params(full, mode)), got)


def test_mixtral_experts_quantize_on_load(tmp_path):
    d = write_checkpoint(tmp_path / "ckpt", hf_tensors(tcfg("mixtral-tiny"), seed=4))
    want = jq.quantize_params(jloader.load_hf_llama(d, jcfg("mixtral-tiny")), "int8")
    got = tloader.load_hf_llama(d, tcfg("mixtral-tiny"), device="cpu", quantization="int8")
    assert got["layers"]["we_down"]["scale"].shape == (2, 4, 1, 64)
    assert_same_tree(want, got)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_a_missing_layer_tensor_loads_as_zeros_in_both(tmp_path, quant):
    # the reference checks the key set and the layer count only, so a
    # checkpoint that lacks one layer's tensor loads that layer as zeros
    # (quantized: codes 0, scale 1); the port mirrors it for parity
    tensors = hf_tensors(tcfg("llama3-tiny"), seed=5)
    del tensors["model.layers.1.mlp.up_proj.weight"]
    d = write_checkpoint(tmp_path / "ckpt", tensors)
    want = jq.quantize_params(jloader.load_hf_llama(d, jcfg("llama3-tiny")), quant)
    got = tloader.load_hf_llama(d, tcfg("llama3-tiny"), device="cpu", quantization=quant)
    assert_same_tree(want, got)
    up = got["layers"]["w_up"]
    if quant:
        assert not up["qw"][1].any() and bool((up["scale"][1] == 1).all())
    else:
        assert not up[1].any() and up[0].any()


def _refusal(tmp_path, case):
    cfg = tcfg("llama3-tiny")
    tensors = hf_tensors(cfg, seed=6)
    model = "llama3-tiny"
    if case == "missing_key":
        tensors = {k: v for k, v in tensors.items() if "q_proj" not in k}
    elif case == "biased":
        tensors = hf_tensors(tcfg("qwen2.5-tiny"), seed=6)
        tensors["lm_head.weight"] = tensors["model.embed_tokens.weight"].clone()
    elif case == "no_embedding":
        del tensors["model.embed_tokens.weight"]
    elif case == "no_final_norm":
        del tensors["model.norm.weight"]
    elif case == "dense_for_moe":
        model = "mixtral-tiny"
    return write_checkpoint(tmp_path / case, tensors), model


@pytest.mark.parametrize("case,match", [
    ("missing_key", r"checkpoint layer params: missing \['wq'\]"),
    ("biased", r"unexpected \['bk', 'bq', 'bv'\] \(a biased checkpoint needs a config with "
               r"attention_bias=True\)"),
    ("no_embedding", "first stage missing embedding"),
    ("no_final_norm", "last stage missing final_norm"),
    ("dense_for_moe", r"missing \['w_router', 'we_down', 'we_gate', 'we_up'\]; "
                      r"unexpected \['w_down', 'w_gate', 'w_up'\]"),
])
def test_validate_refuses_with_the_reference_messages(tmp_path, case, match):
    d, model = _refusal(tmp_path, case)
    with pytest.raises(ValueError, match=match) as want:
        jloader.load_hf_llama(d, jcfg(model))
    with pytest.raises(ValueError) as got:
        tloader.load_hf_llama(d, tcfg(model), device="cpu")
    assert str(got.value) == str(want.value)


def test_a_slice_of_the_wrong_width_is_refused_naming_it(tmp_path):
    tensors = hf_tensors(tcfg("llama3-tiny"), seed=7)
    tensors["model.layers.1.self_attn.k_proj.weight"] = torch.zeros((16, 64), dtype=torch.bfloat16)
    d = write_checkpoint(tmp_path / "ckpt", tensors)
    with pytest.raises(ValueError):
        jloader.load_hf_llama(d, jcfg("llama3-tiny"))
    with pytest.raises(ValueError, match="model.layers.1.self_attn.k_proj.weight"):
        tloader.load_hf_llama(d, tcfg("llama3-tiny"), device="cpu")


def test_orbax_and_missing_directories_are_refused(tmp_path):
    orbax = tmp_path / "orbax"
    (orbax / "params").mkdir(parents=True)
    (orbax / "params" / "_CHECKPOINT_METADATA").write_text("{}")
    cfg = tcfg("llama3-tiny")
    for path in (orbax, tmp_path / "nowhere"):
        with pytest.raises(ValueError, match="orbax checkpoints are JAX-only"):
            tloader.load_or_init_params(cfg, str(path), device="cpu")
        with pytest.raises(ValueError, match="orbax checkpoints are JAX-only"):
            TorchEngine(cfg, EngineConfig(max_batch_size=2, max_seq_len=64),
                        checkpoint_path=str(path), device="cpu")
    # a config.json without shards: FileNotFoundError in both packages
    (tmp_path / "hf").mkdir()
    (tmp_path / "hf" / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError):
        jloader.load_hf_llama(tmp_path / "hf", jcfg("llama3-tiny"))
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        tloader.load_or_init_params(cfg, str(tmp_path / "hf"), device="cpu")


def test_engine_loads_a_checkpoint_and_refuses_it_beside_params(tmp_path):
    d = write_checkpoint(tmp_path / "ckpt", hf_tensors(tcfg("llama3-tiny"), seed=8))
    geom = EngineConfig(max_batch_size=2, max_seq_len=64, quantization="int8")
    eng = TorchEngine("llama3-tiny", geom, checkpoint_path=str(d), device="cpu")
    want = jq.quantize_params(jloader.load_hf_llama(d, jcfg("llama3-tiny")), "int8")
    assert_same_tree(want, eng.params)
    with pytest.raises(ValueError, match="not both"):
        TorchEngine("llama3-tiny", geom, params=params_from_numpy(
            {"embedding": np.zeros((512, 64), np.float32)}, "cpu"),
            checkpoint_path=str(d), device="cpu")


def test_random_init_is_unchanged_without_a_checkpoint():
    # neither params nor checkpoint_path: the seeded random init, quantized
    # leaf by leaf, as before
    cfg = tcfg("llama3-tiny")
    geom = EngineConfig(max_batch_size=2, max_seq_len=64, quantization="int8")
    eng = TorchEngine(cfg, geom, seed=3, device="cpu")
    from distributed_gpu_inference_torch.models import llama as tllama

    gen = torch.Generator(device="cpu").manual_seed(3)
    want = tq.quantize_params(tllama.init_params(cfg, gen, torch.bfloat16, "cpu"), "int8")
    assert_same_tree(params_to_numpy(want), eng.params)
