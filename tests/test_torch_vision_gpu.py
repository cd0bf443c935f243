"""A photo served on the card (``gpu``): ``chip_smoke.py`` phase 27's
request for the 4:2:0 fixture. The vision engine (small-vit + llama3-1b,
decoder bf16) reads the 4032 x 3024 JPEG with the port's decoder, resizes
it with the port's bicubic (both in C++ on the host, to the SHA-256 of
Pillow's answers in the fixtures' manifest), and answers through both
attention kernels: the ragged kernel for the prefill, the fused decode
kernel for each step. The file imports no JAX and no Pillow, so the card
runs it as it is:

    python3 -m pytest -m gpu tests/test_torch_vision_gpu.py --noconftest
"""

import base64
import hashlib
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_gpu_inference_torch import native  # noqa: E402
from distributed_gpu_inference_torch.ops import paged_attention as pa  # noqa: E402
from distributed_gpu_inference_torch.worker.engines.vision import (  # noqa: E402
    VisionEngine,
    _decode_image,
)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "images"
PHOTO = "photo_4032x3024_420_q85.jpg"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_vision_engine_serves_a_photo_through_both_kernels(cuda):
    entry = next(e for e in json.loads((FIXTURES / "manifest.json").read_text())["images"]
                 if e["file"] == PHOTO)
    data = (FIXTURES / PHOTO).read_bytes()
    vis = VisionEngine({"model": "llama3-1b", "vit_model": "small-vit", "device": "cuda",
                        "max_new_tokens": 4, "seed": 0})
    vis.load_model()
    try:
        req = {"task": "image_qa", "question": "what is in the photo?",
               "image": base64.b64encode(data).decode("ascii")}
        native.PLAIN_TAKEN.clear()
        pa.reset_launch_counts()
        out = vis.inference(dict(req))
        torch.cuda.synchronize()
        launches = pa.launch_counts()
        assert launches["ragged_paged_attention"] > 0, launches
        assert launches["paged_decode_attention_fused"] > 0, launches
        assert native.PLAIN_TAKEN == {}
        assert 1 <= out["usage"]["completion_tokens"] <= 4
        image = _decode_image(req, vis._vit_cfg.image_size)
        u8 = np.round(image * 255.0).astype(np.uint8)
        assert hashlib.sha256(u8.tobytes()).hexdigest() == entry["resized_224_sha256"]
    finally:
        vis.unload()
