"""Llama-3-class decoder over paged KV, as plain functions on tensors.

The port of ``distributed_gpu_inference_tpu/models/llama.py``: the same
params layout (a dict of stacked ``[L, ...]`` layer leaves, a ``[V, H]``
embedding, an optional untied ``lm_head``), the same paged KV pools
``[L, N, Hkv, Bk, D]`` with block 0 as the pad block, and one generic
:func:`forward_chunk` for prefill (S = chunk), chunked prefill over a
cached prefix, ragged rounds and decode (S = 1). The layer loop is a
Python loop over the stacked weights; PyTorch runs eagerly, so nothing is
traced or compiled.

Attention goes through ``ops``: a one-query-per-row step (decode) runs the
fused write+attention kernel on the stacked pools; any other chunk writes
its K/V pages and reads through the ragged kernel. On CPU tensors both
take their plain PyTorch versions. The KV pools are updated IN PLACE
(the JAX package donated them and got new arrays back); the returned
``ChunkOutput.kv`` is the same dict.

Quantization. Every projection goes through ``ops.quantization.matmul``:
a weight leaf may be a quantized dict ``{"qw": [L, K, N], "scale": [L,
1, N]}`` (int8 or fp8 codes), sliced per layer as a view. The KV pools may
be bf16/f32, fp8 (e4m3, written with JAX's cast) or int8 with scale pools
``k_scale``/``v_scale`` ``[L, N, Bk]`` bf16 (one scale per page and token,
``ops.attention.quantize_token_rows``): a chunk's rows are quantized on
write before the ragged read, and the fused decode kernel quantizes the
step's row itself.

Dense-family switches covered: Qwen QKV bias, Mistral sliding window,
Gemma ``(1 + w)`` norm, tanh-GeGLU, sqrt(H) embedding scale and final logit
softcap, tied and untied heads. MoE layers are not ported in this slice
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from distributed_gpu_inference_torch.models.configs import ModelConfig
from distributed_gpu_inference_torch.ops.attention import (
    write_kv_pages,
    write_quantized_kv,
)
from distributed_gpu_inference_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    ragged_paged_attention,
)
from distributed_gpu_inference_torch.ops.quantization import is_quantized, matmul

Params = Dict[str, Any]
# {"k": [L,N,Hkv,Bk,D], "v": ...} plus, for int8 pools, {"k_scale":
# [L,N,Bk], "v_scale": ...}
KVPools = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def torch_dtype(dtype: Any) -> torch.dtype:
    """A dtype name (as in ``ModelConfig.dtype``) or torch dtype → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
            "float32": torch.float32, "f32": torch.float32,
            "float16": torch.float16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn,
            "float8_e4m3fn": torch.float8_e4m3fn}[str(dtype)]


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: Any = None,
    device: Any = None,
) -> Params:
    """Random-init params in the JAX package's layout: normal weights
    scaled by fan_in^-0.5, drawn in f32 from ``generator`` (on the
    generator's device unless ``device`` says otherwise) and cast to
    ``dtype``. The values differ from the JAX package's threefry draws;
    tests that compare the two packages build weights once and move them
    over with ``models/convert.py``."""
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    dtype = torch_dtype(dtype or cfg.dtype)
    device = torch.device(device) if device is not None else generator.device
    h, d = cfg.hidden_size, cfg.head_dim
    nh, nkv, i = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    L, v = cfg.num_layers, cfg.vocab_size

    def _w(shape, fan_in):
        w = torch.empty(shape, dtype=dtype, device=device)
        # a few leading rows at a time: the f32 draw stays <= 256 MB
        step = max(1, (1 << 26) // math.prod(shape[1:]))
        for r0 in range(0, shape[0], step):
            r1 = min(shape[0], r0 + step)
            w[r0:r1] = (torch.randn((r1 - r0, *shape[1:]), generator=generator,
                                    device=device, dtype=torch.float32)
                        * (fan_in ** -0.5)).to(dtype)
        return w

    # norm identity depends on the convention: plain RMSNorm scales by w
    # (identity = ones); Gemma's offset form scales by 1+w (identity = zeros)
    norm_init = torch.zeros if cfg.norm_offset else torch.ones
    layers: Dict[str, torch.Tensor] = {
        "attn_norm": norm_init((L, h), dtype=dtype, device=device),
        "wq": _w((L, h, nh * d), h),
        "wk": _w((L, h, nkv * d), h),
        "wv": _w((L, h, nkv * d), h),
        "wo": _w((L, nh * d, h), nh * d),
        "mlp_norm": norm_init((L, h), dtype=dtype, device=device),
        "w_gate": _w((L, h, i), h),
        "w_up": _w((L, h, i), h),
        "w_down": _w((L, i, h), i),
    }
    params: Params = {
        "embedding": _w((v, h), h),
        "layers": layers,
        "final_norm": norm_init((h,), dtype=dtype, device=device),
    }
    if cfg.attention_bias:  # Qwen2-style QKV biases
        layers["bq"] = _w((L, nh * d), nh * d)
        layers["bk"] = _w((L, nkv * d), nkv * d)
        layers["bv"] = _w((L, nkv * d), nkv * d)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _w((v, h), h)
    return params


def init_kv_pools(
    cfg: ModelConfig,
    num_blocks: int,
    block_size: int = 16,
    dtype: Any = None,
    device: Any = "cuda",
) -> KVPools:
    """Paged KV pools ``[L, N, Hkv, Bk, D]`` (head-major pages: a (page,
    head) slice is one contiguous [Bk, D] tile). Block 0 is the pad block:
    pad table entries point at it and reads mask it out.

    ``dtype=int8``: the dict also carries ``k_scale``/``v_scale`` ``[L, N,
    Bk]`` bf16, one scale per (page, token) shared by the KV heads (the
    JAX package repeats it over D: ``[L, N, Bk, D]``). ``fp8``: e4m3 pools,
    no scales."""
    dtype = torch_dtype(dtype or cfg.dtype)
    if dtype not in (torch.bfloat16, torch.float32, torch.float16, torch.int8,
                     torch.float8_e4m3fn):
        raise ValueError(f"unsupported KV pool dtype {dtype}")
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size, cfg.head_dim)
    pools = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        sshape = (cfg.num_layers, num_blocks, block_size)
        pools["k_scale"] = torch.zeros(sshape, dtype=torch.bfloat16, device=device)
        pools["v_scale"] = torch.zeros(sshape, dtype=torch.bfloat16, device=device)
    return pools


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    if offset:  # Gemma stores zero-centered norm weights; scale is (1 + w)
        w = 1.0 + w
    return (x * w).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] → (cos, sin) each [..., S, head_dim//2], float32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE (HF Llama ``rotate_half`` convention).
    x: [B, S, H, D]; cos/sin: [B, S, D/2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _mlp(x: torch.Tensor, lp: Dict[str, Any], activation: str) -> torch.Tensor:
    if activation == "silu":
        gate = F.silu(matmul(x, lp["w_gate"]))
    else:  # Gemma GeGLU (gelu_pytorch_tanh)
        gate = F.gelu(matmul(x, lp["w_gate"]), approximate="tanh")
    return matmul(gate * matmul(x, lp["w_up"]), lp["w_down"]).to(x.dtype)


class ChunkOutput(NamedTuple):
    hidden: torch.Tensor             # [B, S, H] final-layer hidden (pre-norm)
    kv: KVPools                      # the pools, updated in place
    logits: Optional[torch.Tensor]   # [B, S, V] ([B, 1, V] if last_only;
                                     # None if with_logits=False)


def _layer_step(
    cfg: ModelConfig,
    block_size: int,
    hidden: torch.Tensor,
    kv: KVPools,
    layer: int,
    lp: Dict[str, Any],
    *,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    kv_lens: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    fused_decode: bool,
) -> torch.Tensor:
    """One transformer layer over paged KV. ``fused_decode`` routes the
    whole KV path of a one-query-per-row step through the fused
    write+attention op on the stacked pools; otherwise the chunk's K/V rows
    are written to the layer's pages and attention reads them back."""
    b, s, _ = hidden.shape
    nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = rms_norm(hidden, lp["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    q = matmul(x, lp["wq"])
    k = matmul(x, lp["wk"])
    v = matmul(x, lp["wv"])
    if "bq" in lp:  # Qwen2-style attention biases
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = apply_rope(q.reshape(b, s, nh, d), cos, sin)
    k = apply_rope(k.reshape(b, s, nkv, d), cos, sin)
    v = v.reshape(b, s, nkv, d)

    k_pool, v_pool = kv["k"], kv["v"]
    k_scale, v_scale = kv.get("k_scale"), kv.get("v_scale")
    if fused_decode:
        if k_pool.dtype in (torch.int8, torch.float8_e4m3fn):
            # the op quantizes (int8, the shared contract) or casts (fp8)
            # the activation-dtype rows itself
            new_k, new_v = k, v
        else:
            new_k, new_v = k.to(k_pool.dtype), v.to(v_pool.dtype)
        attn, _, _ = paged_decode_attention_fused(
            q, new_k, new_v, k_pool, v_pool, layer,
            block_tables, positions, kv_lens, block_size,
            window=cfg.sliding_window, k_scale=k_scale, v_scale=v_scale,
        )
    else:
        ks = vs = None
        if k_scale is not None:
            ks, vs = k_scale[layer], v_scale[layer]
            write_quantized_kv(k_pool[layer], ks, k, block_tables, positions, block_size)
            write_quantized_kv(v_pool[layer], vs, v, block_tables, positions, block_size)
        else:
            write_kv_pages(k_pool[layer], k, block_tables, positions, block_size)
            write_kv_pages(v_pool[layer], v, block_tables, positions, block_size)
        attn = ragged_paged_attention(
            q, k_pool[layer], v_pool[layer], block_tables, positions, kv_lens,
            block_size, window=cfg.sliding_window, k_scale=ks, v_scale=vs,
        )

    hidden = hidden + matmul(attn.reshape(b, s, nh * d), lp["wo"]).to(hidden.dtype)
    mlp_in = rms_norm(hidden, lp["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    return hidden + _mlp(mlp_in, lp, cfg.activation)


def forward_chunk(
    cfg: ModelConfig,
    params: Params,
    token_ids: torch.Tensor,     # [B, S] int (pad = any id at position -1)
    positions: torch.Tensor,     # [B, S] int32, -1 marks padding
    kv: KVPools,
    block_tables: torch.Tensor,  # [B, M] int32 physical block ids
    kv_lens: torch.Tensor,       # [B] int32 total valid context AFTER this chunk
    *,
    block_size: int = 16,
    last_only: bool = True,
    with_logits: bool = True,
    allow_fused: bool = True,
) -> ChunkOutput:
    """Run S tokens per sequence through all layers against the paged cache.

    Covers prefill (S = prompt chunk, positions start at the cached prefix
    length), ragged rounds (rows with different spans, -1 padded) and
    decode (S = 1, which takes the fused decode op when ``allow_fused``).
    ``with_logits=False`` skips the LM head (an intermediate prefill chunk
    only needs its KV side effects)."""
    layers = params["layers"]
    for name in ("w_router", "we_gate"):
        if name in layers:
            raise NotImplementedError("MoE layers are not ported yet")
    b, s = token_ids.shape
    positions = positions.to(torch.int32)
    kv_lens = kv_lens.to(torch.int32)
    block_tables = block_tables.to(torch.int32)
    hidden = embed_tokens(params, token_ids, cfg)
    cos, sin = rope_angles(positions.clamp(min=0), cfg.head_dim, cfg.rope_theta)
    fused = allow_fused and s == 1
    for layer in range(cfg.num_layers):
        # one layer's leaves as views; a quantized leaf slices both parts
        lp = {name: ({"qw": leaf["qw"][layer], "scale": leaf["scale"][layer]}
                     if is_quantized(leaf) else leaf[layer])
              for name, leaf in layers.items()}
        hidden = _layer_step(
            cfg, block_size, hidden, kv, layer, lp,
            block_tables=block_tables, positions=positions, kv_lens=kv_lens,
            cos=cos, sin=sin, fused_decode=fused,
        )
    if not with_logits:
        return ChunkOutput(hidden=hidden, kv=kv, logits=None)
    if last_only:
        # last valid token per row = (number of valid positions) - 1
        n_valid = (positions >= 0).sum(dim=1)
        last_idx = torch.clamp(n_valid - 1, min=0)
        logits_in = torch.gather(
            hidden, 1, last_idx[:, None, None].expand(b, 1, hidden.shape[-1])
        )
    else:
        logits_in = hidden
    return ChunkOutput(hidden=hidden, kv=kv,
                       logits=project_logits(cfg, params, logits_in))


def embed_tokens(params: Params, token_ids: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Token embedding; Gemma scales by sqrt(hidden_size), rounded to the
    activation dtype first as the JAX package does."""
    hidden = params["embedding"][token_ids.long()]
    if cfg.scale_embeddings:
        hidden = hidden * torch.tensor(cfg.hidden_size ** 0.5, dtype=hidden.dtype,
                                       device=hidden.device)
    return hidden


def project_logits(cfg: ModelConfig, params: Params,
                   hidden: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head in f32 (+ Gemma-2 style softcap)."""
    normed = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps,
                      cfg.norm_offset)
    head = params["lm_head"] if "lm_head" in params else params["embedding"]
    logits = normed.float() @ head.float().t()
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits
