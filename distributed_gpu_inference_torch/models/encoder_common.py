"""Shared building blocks of the non-causal transformer encoders (ViT,
DiT, ASR): LayerNorm, fan-in init, the bidirectional attention block and
patchify/unpatchify.

The port of ``distributed_gpu_inference_tpu/models/encoder_common.py``,
as plain functions over the same params layout: a dict of stacked ``[L,
...]`` leaves that :func:`run_encoder` walks layer by layer (the JAX
package scans them). Two details carry JAX's defaults over: the MLP's
GELU is the tanh approximation (``jax.nn.gelu``'s default), and the
LayerNorm variance is the population variance (``jnp.var``), eps 1e-6.
The bias keys (``bqkv``/``bo``/``b1``/``b2``/``norm1_b``/``norm2_b``) are
optional per checkpoint: first-party inits carry none, an imported HF ViT
carries all of them (``models/loader.py`` ``load_hf_vit``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def fan_in_init(generator: torch.Generator, shape: Tuple[int, ...], fan_in: int,
                dtype: torch.dtype = torch.float32, device: Any = None) -> torch.Tensor:
    """Normal weights scaled by fan_in^-0.5, drawn in f32 from
    ``generator`` (on its device unless ``device`` says otherwise); not
    the JAX package's threefry draws."""
    device = torch.device(device) if device is not None else generator.device
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w * fan_in ** -0.5).to(dtype)


def layer_norm(v: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    mean = v.mean(-1, keepdim=True)
    var = v.var(-1, keepdim=True, unbiased=False)
    out = (v - mean) * torch.rsqrt(var + eps) * w
    return out + b if b is not None else out


def init_encoder_layers(generator: torch.Generator, num_layers: int, hidden: int,
                        mlp_ratio: int = 4, dtype: torch.dtype = torch.float32,
                        device: Any = None) -> Dict[str, torch.Tensor]:
    """Stacked (leading L axis) params of :func:`encoder_block`."""
    L, h = num_layers, hidden
    device = torch.device(device) if device is not None else generator.device

    def _w(shape, fan_in):
        return fan_in_init(generator, shape, fan_in, dtype, device)

    return {
        "norm1": torch.ones((L, h), dtype=dtype, device=device),
        "wqkv": _w((L, h, h * 3), h),
        "wo": _w((L, h, h), h),
        "norm2": torch.ones((L, h), dtype=dtype, device=device),
        "w1": _w((L, h, h * mlp_ratio), h),
        "w2": _w((L, h * mlp_ratio, h), h * mlp_ratio),
    }


def mha(x: torch.Tensor, wqkv: torch.Tensor, wo: torch.Tensor, num_heads: int,
        bqkv: Optional[torch.Tensor] = None,
        bo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional multi-head self-attention over [B, N, H]."""
    b, n, h = x.shape
    hd = h // num_heads
    qkv = x @ wqkv
    if bqkv is not None:
        qkv = qkv + bqkv
    q, k, v = qkv.split(h, dim=-1)

    def heads(z):
        return z.reshape(b, n, num_heads, hd).transpose(1, 2)

    attn = torch.softmax((heads(q) @ heads(k).transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    out = (attn @ heads(v)).transpose(1, 2).reshape(b, n, h) @ wo
    return out + bo if bo is not None else out


def encoder_block(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                  num_heads: int) -> torch.Tensor:
    """Pre-norm transformer encoder block (attention + GELU MLP)."""
    x = x + mha(layer_norm(x, lp["norm1"], lp.get("norm1_b")), lp["wqkv"], lp["wo"],
                num_heads, bqkv=lp.get("bqkv"), bo=lp.get("bo"))
    y = layer_norm(x, lp["norm2"], lp.get("norm2_b"))
    y = y @ lp["w1"]
    if "b1" in lp:
        y = y + lp["b1"]
    y = F.gelu(y, approximate="tanh") @ lp["w2"]
    if "b2" in lp:
        y = y + lp["b2"]
    return x + y


def layer_slice(layers: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves of a stacked tree, as views."""
    return {name: leaf[i] for name, leaf in layers.items()}


def run_encoder(x: torch.Tensor, layers: Dict[str, torch.Tensor],
                num_heads: int) -> torch.Tensor:
    """Every encoder block in turn over the stacked-L params."""
    for i in range(next(iter(layers.values())).shape[0]):
        x = encoder_block(x, layer_slice(layers, i), num_heads)
    return x


def patchify(img: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, S, S, C] → [B, (S/p)^2, p*p*C]."""
    b, s, _, c = img.shape
    g = s // patch
    x = img.reshape(b, g, patch, g, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, patch * patch * c)


def unpatchify(x: torch.Tensor, image_size: int, patch: int,
               channels: int) -> torch.Tensor:
    b = x.shape[0]
    g = image_size // patch
    x = x.reshape(b, g, g, patch, patch, channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, image_size, image_size, channels)
