"""ViT image encoder of the vision-language engine.

The port of ``distributed_gpu_inference_tpu/models/vit.py``: a patch
transformer that encodes an image into ``num_prefix`` soft tokens
projected into the Llama decoder's hidden space. Learned queries are
prepended to the patches (a perceiver-style resampler), and after the
encoder only the query positions go on to the decoder, where they enter
as a hidden-state prefix through ``llama.forward_hidden_chunk``. An HF
ViT import carries a patch bias and an output-norm bias
(``patch_bias``/``out_norm_b``), which :func:`encode_image` applies when
present.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from distributed_gpu_inference_torch.models.encoder_common import (
    fan_in_init,
    init_encoder_layers,
    layer_norm,
    patchify,
    run_encoder,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class ViTConfig:
    name: str = "tiny-vit"
    image_size: int = 32
    channels: int = 3
    patch_size: int = 4
    hidden_size: int = 128
    num_layers: int = 4
    num_heads: int = 4
    out_dim: int = 64            # llama hidden size to project into
    num_prefix: int = 8          # soft tokens handed to the decoder

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels


VIT_REGISTRY: Dict[str, ViTConfig] = {
    "tiny-vit": ViTConfig(),
    "small-vit": ViTConfig(
        name="small-vit", image_size=224, patch_size=16, hidden_size=384,
        num_layers=12, num_heads=6, out_dim=2048, num_prefix=64,
    ),
}


def get_vit_config(name: str) -> ViTConfig:
    if name not in VIT_REGISTRY:
        raise KeyError(f"unknown vit model {name!r}")
    return VIT_REGISTRY[name]


def init_params(cfg: ViTConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random init on the generator's device (not JAX's threefry draws)."""
    h = cfg.hidden_size

    def _w(shape, fan_in):
        return fan_in_init(generator, shape, fan_in, dtype)

    return {
        "patch_proj": _w((cfg.patch_dim, h), cfg.patch_dim),
        "pos_emb": _w((cfg.num_patches, h), h),
        "query_emb": _w((cfg.num_prefix, h), h),
        "layers": init_encoder_layers(generator, cfg.num_layers, h, dtype=dtype),
        "out_norm": torch.ones((h,), dtype=dtype, device=generator.device),
        "out_proj": _w((h, cfg.out_dim), h),
    }


def encode_image(cfg: ViTConfig, params: Params, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] in [0,1] → [B, num_prefix, out_dim] decoder prefix."""
    b = images.shape[0]
    x = patchify(images, cfg.patch_size)
    x = x @ params["patch_proj"] + params["pos_emb"][None]
    if "patch_bias" in params:      # HF ViT imports carry a conv bias
        x = x + params["patch_bias"]
    q = params["query_emb"][None].expand(b, -1, -1)
    x = run_encoder(torch.cat([q, x], dim=1), params["layers"], cfg.num_heads)
    return layer_norm(x[:, : cfg.num_prefix], params["out_norm"],
                      params.get("out_norm_b")) @ params["out_proj"]
