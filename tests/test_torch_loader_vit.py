"""``models/loader.py`` ``load_hf_vit`` of the port against the JAX
package's on synthetic HF ViT checkpoints (google/vit-* layout, written
by ``tests/test_loader_vit.py``'s writer): every imported tensor bit for
bit equal to JAX's import, the CLS slot dropped, the biases live in
``encode_image``, the resampler head seeded fresh, the same validation
errors, and the vision engine loading ``vit_checkpoint_path``. The
resampler head is a ``torch.Generator`` draw, not JAX's threefry, so it
is compared by shape and seeding only."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_gpu_inference_torch.models import vit as tvit  # noqa: E402
from distributed_gpu_inference_torch.models.loader import load_hf_vit  # noqa: E402
from distributed_gpu_inference_tpu.models.loader import load_hf_vit as jload  # noqa: E402
from test_loader_vit import CFG, _reference_tree, _write_hf_checkpoint  # noqa: E402

IMPORTED = ("patch_proj", "patch_bias", "pos_emb", "out_norm", "out_norm_b")
LAYER_KEYS = ("norm1", "norm1_b", "wqkv", "bqkv", "wo", "bo", "norm2", "norm2_b", "w1", "b1",
              "w2", "b2")


@pytest.fixture
def ckpt(tmp_path):
    ref = _reference_tree(jax.random.PRNGKey(3))
    _write_hf_checkpoint(ref, tmp_path)
    return tmp_path, ref


def test_hf_vit_import_is_jax_bit_for_bit(ckpt):
    path, ref = ckpt
    got = load_hf_vit(path, CFG, device="cpu")
    want = jload(path, CFG)
    for k in IMPORTED:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    for k in LAYER_KEYS:
        assert np.array_equal(got["layers"][k].numpy(), np.asarray(want["layers"][k])), k
    assert set(got["layers"]) == set(want["layers"])
    assert not np.any(got["pos_emb"].numpy() == 123.0)     # the CLS poison
    for k in ("query_emb", "out_proj"):
        assert tuple(got[k].shape) == tuple(want[k].shape)
    bf16 = load_hf_vit(path, CFG, dtype="bfloat16", device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in bf16["layers"].values())


def test_hf_vit_import_encodes_with_its_biases(ckpt):
    path, _ = ckpt
    got = load_hf_vit(path, CFG, device="cpu")
    img = torch.from_numpy(np.random.default_rng(9).random((2, 32, 32, 3)).astype(np.float32))
    tcfg = tvit.get_vit_config("tiny-vit")
    out = tvit.encode_image(tcfg, got, img)
    assert out.shape == (2, CFG.num_prefix, CFG.out_dim) and torch.isfinite(out).all()
    stripped = dict(got, layers=dict(got["layers"], bo=torch.zeros_like(got["layers"]["bo"])))
    assert not torch.allclose(out, tvit.encode_image(tcfg, stripped, img))


def test_hf_vit_validation_errors_match_jax(ckpt):
    path, _ = ckpt
    wrong = dataclasses.replace(CFG, image_size=64)
    for load in (load_hf_vit, jload):
        with pytest.raises(ValueError, match="position embeddings cover 64 patches, config "
                                             "expects 256"):
            load(path, wrong)
        with pytest.raises(FileNotFoundError):
            load(path / "nope", CFG)
        with pytest.raises(ValueError, match="unfilled"):
            load(path, dataclasses.replace(CFG, num_layers=CFG.num_layers + 2))
        with pytest.raises(ValueError, match="exceeds config num_layers=2"):
            load(path, dataclasses.replace(CFG, num_layers=2))


def test_resampler_head_is_seeded_fresh(ckpt):
    path, _ = ckpt
    a, b, c = (load_hf_vit(path, CFG, head_seed=s, device="cpu") for s in (0, 0, 1))
    assert torch.equal(a["query_emb"], b["query_emb"])
    assert not torch.equal(a["query_emb"], c["query_emb"])


def test_vision_engine_loads_hf_vit_checkpoint(ckpt):
    from distributed_gpu_inference_torch.worker.engines.vision import VisionEngine

    path, ref = ckpt
    eng = VisionEngine({"model": "llama3-tiny", "vit_model": "tiny-vit", "device": "cpu",
                        "vit_checkpoint_path": str(path), "max_new_tokens": 2})
    eng.load_model()
    assert np.array_equal(eng._vit_params["patch_proj"].numpy(), np.asarray(ref["patch_proj"]))
    assert "bqkv" in eng._vit_params["layers"]
    out = eng.inference({"task": "caption",
                         "pixels": np.zeros((32, 32, 3), np.float32).tolist()})
    assert out["usage"]["completion_tokens"] <= 2
