"""Compact DiT (diffusion transformer) for text-to-image generation.

The port of ``distributed_gpu_inference_tpu/models/diffusion.py``: a
patch transformer with AdaLN-zero conditioning, and a DDIM sampler with
classifier-free guidance batched as 2B. The JAX package runs the sampling
loop as one jitted ``lax.fori_loop``; here :func:`ddim_sample` is an eager
loop of ``num_steps`` :func:`denoise` calls on the device, with no host
sync until the image is read. The schedule is JAX's: ``step_ts`` is
``linspace(T-1, 0, steps)`` in f32 (jnp.linspace's formula,
:func:`_linspace_f32`) truncated to int32, the same timesteps as JAX's,
and ``alphas_bar`` a cumprod in f32 (within an ulp or two of JAX's,
whose compiler folds the constant linspace with its own rounding). The first noise comes from a ``torch.Generator`` (not JAX's threefry)
or, port-only, from the caller (``noise=``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from distributed_gpu_inference_torch.models.encoder_common import (
    fan_in_init,
    layer_norm,
    layer_slice,
    mha,
    patchify as _patchify_img,
    unpatchify as _unpatchify_img,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class DiffusionConfig:
    name: str = "tiny-diffusion"
    image_size: int = 32
    channels: int = 3
    patch_size: int = 4
    hidden_size: int = 128
    num_layers: int = 4
    num_heads: int = 4
    text_vocab: int = 260            # byte tokenizer vocab
    max_text_len: int = 64
    timesteps: int = 1000

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels


DIFFUSION_REGISTRY: Dict[str, DiffusionConfig] = {
    "tiny-diffusion": DiffusionConfig(),
    "small-diffusion": DiffusionConfig(
        name="small-diffusion", image_size=64, patch_size=4,
        hidden_size=384, num_layers=8, num_heads=6,
    ),
}


def get_diffusion_config(name: str) -> DiffusionConfig:
    if name not in DIFFUSION_REGISTRY:
        raise KeyError(
            f"unknown diffusion model {name!r}; known: {sorted(DIFFUSION_REGISTRY)}"
        )
    return DIFFUSION_REGISTRY[name]


def init_params(cfg: DiffusionConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random init on the generator's device (not JAX's threefry draws)."""
    h, p, L = cfg.hidden_size, cfg.patch_dim, cfg.num_layers
    dev = generator.device

    def _w(shape, fan_in):
        return fan_in_init(generator, shape, fan_in, dtype)

    return {
        "patch_proj": _w((p, h), p),
        "pos_emb": _w((cfg.num_patches, h), h),
        "text_emb": _w((cfg.text_vocab, h), h),
        "time_mlp1": _w((h, h * 2), h),
        "time_mlp2": _w((h * 2, h), h * 2),
        "layers": {
            "norm_scale": torch.ones((L, h), dtype=dtype, device=dev),
            "ada": _w((L, h, h * 6), h),
            "wqkv": _w((L, h, h * 3), h),
            "wo": _w((L, h, h), h),
            "w1": _w((L, h, h * 4), h),
            "w2": _w((L, h * 4, h), h * 4),
        },
        "out_norm": torch.ones((h,), dtype=dtype, device=dev),
        "out_proj": _w((h, p), h),
    }


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of diffusion time [B] → [B, dim], cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def patchify(cfg: DiffusionConfig, img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] → [B, N, patch_dim]."""
    return _patchify_img(img, cfg.patch_size)


def unpatchify(cfg: DiffusionConfig, x: torch.Tensor) -> torch.Tensor:
    return _unpatchify_img(x, cfg.image_size, cfg.patch_size, cfg.channels)


def encode_text(cfg: DiffusionConfig, params: Params,
                token_ids: torch.Tensor) -> torch.Tensor:
    """Mean-pooled text embedding [B, T] → [B, H] (pad id 0 masked)."""
    emb = params["text_emb"][token_ids.long()]
    mask = (token_ids > 0).to(emb.dtype)[..., None]
    denom = torch.clamp(mask.sum(dim=1), min=1.0)
    return (emb * mask).sum(dim=1) / denom


def denoise(cfg: DiffusionConfig, params: Params, x_t: torch.Tensor,
            t: torch.Tensor, text_cond: torch.Tensor) -> torch.Tensor:
    """Predict noise for x_t at time t. x_t [B,H,W,C], t [B], cond [B,Hd]."""
    h = cfg.hidden_size
    x = patchify(cfg, x_t) @ params["patch_proj"] + params["pos_emb"][None]
    temb = _timestep_embedding(t, h)
    c = F.silu(temb @ params["time_mlp1"]) @ params["time_mlp2"]
    c = c + text_cond                                   # [B, H]
    layers = params["layers"]
    for i in range(layers["ada"].shape[0]):
        lp = layer_slice(layers, i)
        # AdaLN-zero: per-layer modulation from the conditioning vector
        mod = (c @ lp["ada"]).reshape(x.shape[0], 1, 6, h)
        s1, b1, g1, s2, b2, g2 = (mod[:, :, j] for j in range(6))
        y = layer_norm(x, lp["norm_scale"]) * (1 + s1) + b1
        y = mha(y, lp["wqkv"], lp["wo"], cfg.num_heads)
        x = x + g1 * y
        y = layer_norm(x, lp["norm_scale"]) * (1 + s2) + b2
        y = F.gelu(y @ lp["w1"], approximate="tanh") @ lp["w2"]
        x = x + g2 * y
    x = layer_norm(x, params["out_norm"]) @ params["out_proj"]
    return unpatchify(cfg, x)


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in f32, by its formula:
    ``start·(1-s) + stop·s`` with ``s = iota/div``, the endpoint exact."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / torch.tensor(float(div))
    a = torch.tensor(start, dtype=torch.float32)
    b = torch.tensor(stop, dtype=torch.float32)
    return torch.cat([a * (1 - step) + b * step, b[None]])


def schedule(cfg: DiffusionConfig, num_steps: int):
    """(alphas_bar [T] f32, step_ts [num_steps] int32), on the host."""
    betas = _linspace_f32(1e-4, 0.02, cfg.timesteps)
    alphas_bar = torch.cumprod(1.0 - betas, dim=0)
    step_ts = _linspace_f32(float(cfg.timesteps - 1), 0.0, num_steps).to(torch.int32)
    return alphas_bar, step_ts


def ddim_sample(
    cfg: DiffusionConfig,
    params: Params,
    text_tokens: torch.Tensor,       # [B, T] int, 0 = pad
    generator: Optional[torch.Generator] = None,
    num_steps: int = 20,
    guidance_scale: float = 3.0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM sampler with classifier-free guidance (conditional and
    unconditional branches as one 2B batch a step). The first ``x`` is
    ``noise`` when given, else a standard normal drawn from ``generator``
    on the params' device. Returns images [B, S, S, C] in [0, 1]."""
    dev = params["patch_proj"].device
    b = text_tokens.shape[0]
    text_tokens = text_tokens.to(dev)
    cond = encode_text(cfg, params, text_tokens)
    uncond = encode_text(cfg, params, torch.zeros_like(text_tokens))
    both = torch.cat([cond, uncond])
    alphas_bar, step_ts = schedule(cfg, num_steps)
    shape = (b, cfg.image_size, cfg.image_size, cfg.channels)
    if noise is None:
        x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
    else:
        x = noise.to(device=dev, dtype=torch.float32)
    ts = step_ts.tolist()
    for i, t in enumerate(ts):
        a_t = alphas_bar[t]
        a_next = alphas_bar[ts[i + 1]] if i + 1 < num_steps else torch.tensor(1.0)
        tb = torch.full((2 * b,), t, dtype=torch.int32, device=dev)
        eps = denoise(cfg, params, torch.cat([x, x]), tb, both)
        eps_c, eps_u = eps[:b], eps[b:]
        eps_g = eps_u + guidance_scale * (eps_c - eps_u)
        # the coefficients are 0-d f32 tensors on the host (a CUDA
        # operand takes them as scalars)
        x0 = (x - torch.sqrt(1 - a_t) * eps_g) / torch.sqrt(a_t)
        x0 = torch.clamp(x0, -1.5, 1.5)
        x = torch.sqrt(a_next) * x0 + torch.sqrt(1 - a_next) * eps_g
    return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)
