"""Llama-3-class decoder over paged KV, as plain functions on tensors.

The port of ``distributed_gpu_inference_tpu/models/llama.py``: the same
params layout (a dict of stacked ``[L, ...]`` layer leaves, a ``[V, H]``
embedding, an optional untied ``lm_head``), the same paged KV pools
``[L, N, Hkv, Bk, D]`` with block 0 as the pad block, and one generic
:func:`forward_chunk` for prefill (S = chunk), chunked prefill over a
cached prefix, ragged rounds and decode (S = 1), and
:func:`forward_hidden_chunk` for pre-embedded hidden states (the vision
engine's image prefix; a pipeline stage's layers). The layer loop is a
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

Family switches covered: Qwen QKV bias, Mistral sliding window, Gemma
``(1 + w)`` norm, tanh-GeGLU, sqrt(H) embedding scale and final logit
softcap, tied and untied heads, and Mixtral's sparse expert MLP
(:func:`_moe_mlp`, taken when a layer carries ``w_router``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from distributed_gpu_inference_torch.models.configs import ModelConfig
from distributed_gpu_inference_torch.ops.attention import (
    dequantize_kv,
    quantize_token_rows,
    token_amax,
    write_kv_pages,
    write_quantized_kv,
)
from distributed_gpu_inference_torch.ops.paged_attention import (
    paged_decode_attention_fused,
    ragged_paged_attention,
)
from distributed_gpu_inference_torch.ops.quantization import (
    QUANT_KEYS,
    is_quantized,
    matmul,
    quantize_stacked,
)

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


def normal_leaf(shape: Tuple[int, ...], fan_in: int, generator: torch.Generator,
                dtype: torch.dtype, device: Any, name: str = "",
                shard: Optional[Tuple[int, int]] = None,
                quantization: Optional[str] = None) -> Any:
    """Normal weights scaled by fan_in^-0.5, drawn in f32 from
    ``generator`` a few leading rows at a time (the f32 draw stays <= 256
    MB) and cast to ``dtype``.

    ``shard=(rank, tp)``: only rank ``rank``'s part of the leaf ``name``
    is kept, from the same draws: each chunk is rounded to ``dtype``,
    quantized whole when ``quantization`` names a mode and the leaf is a
    matmul weight (the per-column scale of a row-parallel weight reduces
    its whole K), and only then cut (``parallel/sharding.py``); the whole
    leaf never exists on the device, only one chunk of it."""
    # parallel/__init__ imports the pipeline planner, which imports this
    # module: the rules are imported where they are used
    from distributed_gpu_inference_torch.parallel.sharding import (
        cut,
        cut_quantized,
        leaf_axis,
    )

    rank, tp = shard or (0, 1)
    quantize = quantization is not None and name in QUANT_KEYS
    step = max(1, (1 << 26) // math.prod(shape[1:]))
    out: Any = None
    for r0 in range(0, shape[0], step):
        r1 = min(shape[0], r0 + step)
        w = (torch.randn((r1 - r0, *shape[1:]), generator=generator, device=device,
                         dtype=torch.float32) * (fan_in ** -0.5)).to(dtype)
        part = (cut_quantized(name, quantize_stacked(w, quantization), rank, tp)
                if quantize else cut(w, leaf_axis(name), rank, tp))
        del w
        if out is None:
            out = ({k: torch.empty((shape[0], *v.shape[1:]), dtype=v.dtype, device=device)
                    for k, v in part.items()} if quantize else
                   torch.empty((shape[0], *part.shape[1:]), dtype=part.dtype, device=device))
        if quantize:
            for k in out:
                out[k][r0:r1] = part[k]
        else:
            out[r0:r1] = part
    return out


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: Any = None,
    device: Any = None,
    shard: Optional[Tuple[int, int]] = None,
    quantization: Optional[str] = None,
) -> Params:
    """Random-init params in the JAX package's layout: normal weights
    scaled by fan_in^-0.5, drawn in f32 from ``generator`` (on the
    generator's device unless ``device`` says otherwise) and cast to
    ``dtype``. The values differ from the JAX package's threefry draws;
    tests that compare the two packages build weights once and move them
    over with ``models/convert.py``.

    ``quantization``: the matmul weights quantized to that mode as they
    are drawn (:func:`normal_leaf`), a few layers at a time, so the whole
    full-precision tree never exists; the values are those of
    ``quantize_params`` of the unquantized tree. ``shard=(rank, tp)``: rank
    ``rank``'s part of the same tree under the tensor-parallel rules, each
    leaf drawn as the whole tree draws it, quantized whole, then cut."""
    dtype = torch_dtype(dtype or cfg.dtype)
    device = torch.device(device) if device is not None else generator.device
    h, d = cfg.hidden_size, cfg.head_dim
    nh, nkv, i = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    L, v = cfg.num_layers, cfg.vocab_size

    def _w(name, shape, fan_in):
        return normal_leaf(shape, fan_in, generator, dtype, device, name, shard,
                           quantization)

    # norm identity depends on the convention: plain RMSNorm scales by w
    # (identity = ones); Gemma's offset form scales by 1+w (identity = zeros)
    norm_init = torch.zeros if cfg.norm_offset else torch.ones
    layers: Dict[str, Any] = {
        "attn_norm": norm_init((L, h), dtype=dtype, device=device),
        "wq": _w("wq", (L, h, nh * d), h),
        "wk": _w("wk", (L, h, nkv * d), h),
        "wv": _w("wv", (L, h, nkv * d), h),
        "wo": _w("wo", (L, nh * d, h), nh * d),
        "mlp_norm": norm_init((L, h), dtype=dtype, device=device),
    }
    if cfg.num_experts:  # Mixtral-style sparse MoE: stacked expert axis E
        e = cfg.num_experts
        layers["w_router"] = _w("w_router", (L, h, e), h)
        layers["we_gate"] = _w("we_gate", (L, e, h, i), h)
        layers["we_up"] = _w("we_up", (L, e, h, i), h)
        layers["we_down"] = _w("we_down", (L, e, i, h), i)
    else:
        layers["w_gate"] = _w("w_gate", (L, h, i), h)
        layers["w_up"] = _w("w_up", (L, h, i), h)
        layers["w_down"] = _w("w_down", (L, i, h), i)
    params: Params = {
        "embedding": _w("embedding", (v, h), h),
        "layers": layers,
        "final_norm": norm_init((h,), dtype=dtype, device=device),
    }
    if cfg.attention_bias:  # Qwen2-style QKV biases
        layers["bq"] = _w("bq", (L, nh * d), nh * d)
        layers["bk"] = _w("bk", (L, nkv * d), nkv * d)
        layers["bv"] = _w("bv", (L, nkv * d), nkv * d)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _w("lm_head", (v, h), h)
    return params


def init_kv_pools(
    cfg: ModelConfig,
    num_blocks: int,
    block_size: int = 16,
    dtype: Any = None,
    device: Any = "cuda",
    tp: int = 1,
) -> KVPools:
    """Paged KV pools ``[L, N, Hkv, Bk, D]`` (head-major pages: a (page,
    head) slice is one contiguous [Bk, D] tile). Block 0 is the pad block:
    pad table entries point at it and reads mask it out. ``tp`` > 1: one
    rank's pools, ``Hkv / tp`` heads (the scale pools stay whole).

    ``dtype=int8``: the dict also carries ``k_scale``/``v_scale`` ``[L, N,
    Bk]`` bf16, one scale per (page, token) shared by the KV heads (the
    JAX package repeats it over D: ``[L, N, Bk, D]``). ``fp8``: e4m3 pools,
    no scales."""
    dtype = torch_dtype(dtype or cfg.dtype)
    if dtype not in (torch.bfloat16, torch.float32, torch.float16, torch.int8,
                     torch.float8_e4m3fn):
        raise ValueError(f"unsupported KV pool dtype {dtype}")
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads // tp, block_size, cfg.head_dim)
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


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")   # Gemma GeGLU (gelu_pytorch_tanh)


def _row_sum(y: torch.Tensor, tp: Optional[Any]) -> torch.Tensor:
    """A row-parallel product's partial sum, summed over the ``model``
    ranks (in place); the product itself without tensor parallelism."""
    return y if tp is None else tp.all_reduce_sum(y)


def _mlp(x: torch.Tensor, lp: Dict[str, Any], activation: str,
         tp: Optional[Any] = None) -> torch.Tensor:
    gate = _act(matmul(x, lp["w_gate"]), activation)
    return _row_sum(matmul(gate * matmul(x, lp["w_up"]), lp["w_down"]), tp).to(x.dtype)


def sorted_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, descending, equal
    values lower index first (a stable sort; ``torch.topk`` promises no
    order among equals)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_experts(xf: torch.Tensor, w_router: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF Mixtral's routing of tokens ``xf [T, H]``: the router product in
    f32, softmax over every expert, the top ``k`` renormalized. → (dense
    ``[T, E]`` f32 combine weights, zero off the top k; the top-k expert
    ids ``[T, k]``). Ties resolve as ``lax.top_k`` resolves them, the lower
    expert first (``sorted_top_k``)."""
    probs = torch.softmax(xf.float() @ w_router.float(), dim=-1)
    topv, topi = sorted_top_k(probs, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter_(1, topi, topv), topi


def _moe_mlp(x: torch.Tensor, lp: Dict[str, Any], cfg: ModelConfig,
             tp: Optional[Any] = None) -> torch.Tensor:
    """Mixtral-style sparse MoE MLP (JAX ``models/llama.py`` ``_moe_mlp``).

    Every expert runs on every token and the dense ``[T, E]`` combine
    weights (zero off each token's top k) mix their outputs, as the JAX
    package does: the step stays free of host syncs (no ``.item()``, no
    ``nonzero`` on the routing), so it can be captured in a CUDA graph.
    The cost is E/k times the routed products. Each expert's products go
    through :func:`ops.quantization.matmul` on views of its stack: a
    quantized ``{"qw": [E, K, N], "scale": [E, 1, N]}`` as ``qw[e]`` (the
    W8A16 kernel up to its row bound, the library route above it), a
    plain ``[E, K, N]`` as ``w[e]``.

    The sum over experts is taken in f32, ``weights[:, e] * per_expert``,
    then rounded to x's dtype. With k = 2 a dispatch that skips the
    unrouted experts gives the same f32 sum bit for bit, as long as every
    expert output is finite: the zero terms add nothing and two terms
    commute. That is the premise of a later grouped dispatch.

    One arithmetic difference from the JAX package: its ``_deq`` rounds
    ``code * scale`` to the activation dtype before the product, while the
    kernel accumulates ``x @ codes`` in f32 and scales the sum once. In f32
    the two agree to rounding; in bf16 they differ by the weight's
    rounding."""
    b, s, h = x.shape
    xf = x.reshape(b * s, h)
    weights, _ = route_experts(xf, lp["w_router"], cfg.num_experts_per_tok)
    stack = lp["we_gate"]["qw"] if is_quantized(lp["we_gate"]) else lp["we_gate"]
    n_local = stack.shape[0]
    e0 = 0 if tp is None else tp.rank * n_local
    out = torch.zeros((b * s, h), dtype=torch.float32, device=x.device)
    for e in range(n_local):
        w = {n: ({"qw": lp[n]["qw"][e], "scale": lp[n]["scale"][e]}
                 if is_quantized(lp[n]) else lp[n][e])
             for n in ("we_gate", "we_up", "we_down")}
        gate = _act(matmul(xf, w["we_gate"]), cfg.activation)
        per_e = matmul(gate * matmul(xf, w["we_up"]), w["we_down"])
        out += weights[:, e0 + e, None] * per_e.float()
    return _row_sum(out, tp).reshape(b, s, h).to(x.dtype)


class ChunkOutput(NamedTuple):
    hidden: torch.Tensor             # [B, S, H] final-layer hidden (pre-norm)
    kv: KVPools                      # the pools, updated in place
    logits: Optional[torch.Tensor]   # [B, S, V] ([B, 1, V] if last_only;
                                     # None if with_logits=False)
    # [B, S, k*H]: the post-layer hiddens of ``collect_layers`` side by
    # side (EAGLE-3 draft features); None unless requested
    features: Optional[torch.Tensor] = None


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
    write_positions: Optional[torch.Tensor] = None,
    write_tables: Optional[torch.Tensor] = None,
    attn_fn: Optional[Any] = None,
    tp: Optional[Any] = None,
    dense_attn_fn: Optional[Any] = None,
    gather_rows: Optional[Any] = None,
) -> torch.Tensor:
    """One transformer layer over paged KV. ``fused_decode`` routes the
    whole KV path of a one-query-per-row step through the fused
    write+attention op on the stacked pools; otherwise the chunk's K/V rows
    are written to the layer's pages and attention reads them back.

    The tree-verify pass writes its rows at ``write_positions`` (node
    slots; default ``positions``) and reads through ``attn_fn(q, k_pool,
    v_pool, k_scale, v_scale)`` (one layer's pools) instead of the ragged
    kernel.

    Tensor parallelism (``tp``): the layer's leaves are the rank's shard,
    so the head counts come from the projections' widths (Nh/tp query
    and Nkv/tp KV heads); the ``wo`` and MLP products are summed over the
    ranks before they join ``hidden``; an int8 pool's per-token amax
    (over every KV head, on every rank) is max-reduced over the ranks
    before the rows are quantized, so scales and codes are those of the
    one-rank engine's contract.

    The sequence axis (``forward_chunk``'s hooks): ``write_tables`` are
    the tables the pages are written through (a block-sharded rank's
    local ids), ``gather_rows`` gathers the K/V rows of every rank before
    they are written, and ``dense_attn_fn`` attends over this chunk's own
    K/V."""
    b, s, _ = hidden.shape
    d = cfg.head_dim
    x = rms_norm(hidden, lp["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    q = matmul(x, lp["wq"])
    k = matmul(x, lp["wk"])
    v = matmul(x, lp["wv"])
    if "bq" in lp:  # Qwen2-style attention biases
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    nh, nkv = q.shape[-1] // d, k.shape[-1] // d
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
        wpos = positions if write_positions is None else write_positions
        wtab = block_tables if write_tables is None else write_tables
        wk, wv = (k, v) if gather_rows is None else (gather_rows(k), gather_rows(v))
        ks = vs = None
        amax_k = amax_v = None
        if k_scale is not None:
            ks, vs = k_scale[layer], v_scale[layer]
            wamax_k = wamax_v = None
            if tp is not None:
                amax = tp.all_reduce_max(torch.stack([token_amax(k, (2, 3)),
                                                      token_amax(v, (2, 3))]))
                amax_k, amax_v = amax[0], amax[1]
                wamax_k, wamax_v = amax_k, amax_v
                if gather_rows is not None:
                    # every seq rank's rows are written: their amaxes too
                    wamax_k, wamax_v = gather_rows(torch.cat([amax_k, amax_v], -1)).split(1, -1)
            write_quantized_kv(k_pool[layer], ks, wk, wtab, wpos, block_size, amax=wamax_k)
            write_quantized_kv(v_pool[layer], vs, wv, wtab, wpos, block_size, amax=wamax_v)
        else:
            write_kv_pages(k_pool[layer], wk, wtab, wpos, block_size)
            write_kv_pages(v_pool[layer], wv, wtab, wpos, block_size)
        if dense_attn_fn is not None:
            # the chunk is the whole context: attend over its own K/V, an
            # int8 pool's through the quantize-dequantize round trip its
            # pages hold, so the read matches the one-device paged read
            if k_scale is not None:
                k = dequantize_kv(*quantize_token_rows(k, (2, 3), amax_k))
                v = dequantize_kv(*quantize_token_rows(v, (2, 3), amax_v))
            attn = dense_attn_fn(q, k, v)
        elif attn_fn is not None:
            attn = attn_fn(q, k_pool[layer], v_pool[layer], ks, vs)
        else:
            attn = ragged_paged_attention(
                q, k_pool[layer], v_pool[layer], block_tables, positions, kv_lens,
                block_size, window=cfg.sliding_window, k_scale=ks, v_scale=vs,
            )

    hidden = hidden + _row_sum(matmul(attn.reshape(b, s, nh * d), lp["wo"]),
                               tp).to(hidden.dtype)
    mlp_in = rms_norm(hidden, lp["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    if "w_router" in lp:
        return hidden + _moe_mlp(mlp_in, lp, cfg, tp)
    return hidden + _mlp(mlp_in, lp, cfg.activation, tp)


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
    collect_layers: Optional[Tuple[int, ...]] = None,
    tp: Optional[Any] = None,
    dense_attn_fn: Optional[Any] = None,
    attn_fn: Optional[Any] = None,
    pool_blocks: Optional[Tuple[int, int]] = None,
    gather_rows: Optional[Any] = None,
    write_positions: Optional[torch.Tensor] = None,
) -> ChunkOutput:
    """Run S tokens per sequence through all layers against the paged cache.

    Covers prefill (S = prompt chunk, positions start at the cached prefix
    length), ragged rounds (rows with different spans, -1 padded) and
    decode (S = 1, which takes the fused decode op when ``allow_fused``).
    ``with_logits=False`` skips the LM head (an intermediate prefill chunk
    only needs its KV side effects). ``collect_layers`` also returns
    ``ChunkOutput.features``, those layers' post-layer hiddens side by side
    (the EAGLE-3 draft features).

    ``tp`` (a ``parallel.mesh.TPGroup``): ``params`` and ``kv`` are this
    rank's shards (``parallel/sharding.py``) and every rank of the group
    runs the same call with the same inputs; the collectives are inside.
    A decode step over int8 pools then writes through the max-reduced
    quantize and reads through the ragged kernel (the fused kernel
    quantizes over the rank's own heads only); bf16 and fp8 pools keep
    the fused kernel on the rank's heads.

    The sequence axis (JAX ``dense_attn_fn`` / ``attn_override``; the
    closures are ``parallel/ring_attention.py``'s ops bound to a rank's
    group, built by ``runtime/tp.py``): ``dense_attn_fn(q, k, v)`` attends
    over this chunk's own K/V instead of the pools, valid when the chunk
    is the whole context (ring or Ulysses attention of a seq-parallel
    prefill, or a fresh prompt on block-sharded pools); ``attn_fn(q,
    layer_k, layer_v, k_scale, v_scale)`` replaces the paged read (the
    partial-softmax decode and chunk reads of block-sharded pools, bound
    to this call's tables, positions and lengths). ``pool_blocks=(lo, hi)``: ``kv`` holds the global
    blocks [lo, hi) only, at local ids 0..hi-lo; a K/V row is written only
    where its block is held. ``gather_rows`` (with ``write_positions``, the
    gathered rows' positions): the rows written to the pages are
    ``gather_rows`` of this rank's rows, every rank's rows of a
    seq-parallel prefill. Any hook turns the fused decode kernel off."""
    positions = positions.to(torch.int32)
    hooked = (dense_attn_fn is not None or attn_fn is not None
              or pool_blocks is not None or gather_rows is not None)
    fused = (allow_fused and token_ids.shape[1] == 1 and not hooked
             and not (tp is not None and "k_scale" in kv))
    hidden, features = _run_hidden(
        cfg, params, embed_tokens(params, token_ids, cfg), positions, kv, block_tables, kv_lens,
        block_size=block_size, fused_decode=fused, collect_layers=collect_layers, tp=tp,
        dense_attn_fn=dense_attn_fn, attn_fn=attn_fn, pool_blocks=pool_blocks,
        gather_rows=gather_rows, write_positions=write_positions,
    )
    if not with_logits:
        return ChunkOutput(hidden=hidden, kv=kv, logits=None, features=features)
    if last_only:
        # last valid token per row = (number of valid positions) - 1
        n_valid = (positions >= 0).sum(dim=1)
        last_idx = torch.clamp(n_valid - 1, min=0)
        logits_in = torch.gather(
            hidden, 1, last_idx[:, None, None].expand(-1, 1, hidden.shape[-1])
        )
    else:
        logits_in = hidden
    return ChunkOutput(hidden=hidden, kv=kv,
                       logits=project_logits(cfg, params, logits_in),
                       features=features)


def _run_hidden(
    cfg: ModelConfig, params: Params, hidden: torch.Tensor,
    rope_positions: torch.Tensor, kv: KVPools, block_tables: torch.Tensor,
    kv_lens: torch.Tensor, *, block_size: int, fused_decode: bool = False,
    collect_layers: Optional[Tuple[int, ...]] = None,
    write_positions: Optional[torch.Tensor] = None, attn_fn: Optional[Any] = None,
    tp: Optional[Any] = None, dense_attn_fn: Optional[Any] = None,
    pool_blocks: Optional[Tuple[int, int]] = None, gather_rows: Optional[Any] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run every layer of ``params`` over pre-embedded ``hidden`` → (final
    hidden, the ``collect_layers`` features or None)."""
    layers = params["layers"]
    kv_lens = kv_lens.to(torch.int32)
    block_tables = block_tables.to(torch.int32)
    write_tables = None
    if pool_blocks is not None:
        wpos = rope_positions if write_positions is None else write_positions
        write_tables, write_positions = held_writes(block_tables, wpos.to(torch.int32),
                                                    block_size, *pool_blocks)
    cos, sin = rope_angles(rope_positions.clamp(min=0), cfg.head_dim, cfg.rope_theta)
    collected = {}
    for layer in range(kv["k"].shape[0]):
        # one layer's leaves as views; a quantized leaf slices both parts
        lp = {name: ({"qw": leaf["qw"][layer], "scale": leaf["scale"][layer]}
                     if is_quantized(leaf) else leaf[layer])
              for name, leaf in layers.items()}
        hidden = _layer_step(
            cfg, block_size, hidden, kv, layer, lp,
            block_tables=block_tables, positions=rope_positions, kv_lens=kv_lens,
            cos=cos, sin=sin, fused_decode=fused_decode,
            write_positions=write_positions, write_tables=write_tables, attn_fn=attn_fn,
            tp=tp, dense_attn_fn=dense_attn_fn, gather_rows=gather_rows,
        )
        if collect_layers is not None and layer in collect_layers:
            collected[layer] = hidden
    features = (torch.cat([collected[i] for i in collect_layers], dim=-1)
                if collect_layers is not None else None)
    return hidden, features


def held_writes(block_tables: torch.Tensor, positions: torch.Tensor, block_size: int,
                lo: int, hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The page writes a rank that holds the global blocks [lo, hi) makes:
    (tables in its local ids, ``positions`` with -1 wherever the row's
    block is not held, so the write drops the row)."""
    logical = positions.clamp(min=0).long() // block_size
    phys = torch.gather(block_tables.long(), 1, logical)
    held = (positions >= 0) & (phys >= lo) & (phys < hi)
    return block_tables - lo, torch.where(held, positions, torch.full_like(positions, -1))


def forward_tree_chunk(
    cfg: ModelConfig,
    params: Params,
    token_ids: torch.Tensor,        # [B, N] tree-node tokens
    rope_positions: torch.Tensor,   # [B, N] semantic positions (prefix + depth)
    cache_positions: torch.Tensor,  # [B, N] KV slot positions (prefix + node idx, -1 = none)
    kv: KVPools,
    block_tables: torch.Tensor,     # [B, M]
    prefix_lens: torch.Tensor,      # [B] committed context before the tree
    tree_mask: torch.Tensor,        # [N, N] ancestor-visibility mask
    *,
    block_size: int = 16,
    collect_layers: Optional[Tuple[int, ...]] = None,
) -> ChunkOutput:
    """Target forward over a speculative token tree (the verify pass).

    RoPE uses semantic depth positions; KV rows are written at distinct
    node-indexed slots so siblings don't collide (int8 pools quantize them
    through the shared per-token contract), and attention is
    :func:`ops.attention.paged_tree_attention`: the committed prefix plus
    each node's ancestors, windowed by semantic position for
    sliding-window models. Logits for every node."""
    from distributed_gpu_inference_torch.ops.attention import paged_tree_attention

    rope_positions = rope_positions.to(torch.int32)
    tables = block_tables.to(torch.int32)

    def attn_fn(q, layer_k, layer_v, layer_ks, layer_vs):
        return paged_tree_attention(
            q, layer_k, layer_v, tables, prefix_lens, tree_mask, block_size,
            node_positions=rope_positions, window=cfg.sliding_window,
            k_scale=layer_ks, v_scale=layer_vs,
        )

    hidden, features = _run_hidden(
        cfg, params, embed_tokens(params, token_ids, cfg), rope_positions, kv, tables,
        prefix_lens,
        block_size=block_size, collect_layers=collect_layers,
        write_positions=cache_positions.to(torch.int32), attn_fn=attn_fn,
    )
    return ChunkOutput(hidden=hidden, kv=kv, logits=project_logits(cfg, params, hidden),
                       features=features)


def forward_hidden_chunk(
    cfg: ModelConfig,
    params: Params,
    hidden: torch.Tensor,        # [B, S, H] pre-embedded activations
    positions: torch.Tensor,     # [B, S] int32, -1 marks padding
    kv: KVPools,
    block_tables: torch.Tensor,  # [B, M]
    kv_lens: torch.Tensor,       # [B] total valid context AFTER this chunk
    *,
    block_size: int = 16,
) -> Tuple[torch.Tensor, KVPools]:
    """Run pre-embedded hidden states through the layers of ``params``
    (and of ``kv``, which hold the same layers) → (final hidden, the
    pools, updated in place).

    The entry of a pipeline stage that owns a range of layers, and of the
    vision engine, whose image prefix enters as hidden states. A chunk
    with S = 1 takes the fused decode op, any other the ragged kernel;
    positions of -1 write no KV. int8 KV pools raise
    ``NotImplementedError``, as in the JAX package (stage pools are
    bf16/f32)."""
    if "k_scale" in kv:
        raise NotImplementedError(
            "forward_hidden_chunk over int8 KV pools is not wired"
        )
    positions = positions.to(torch.int32)
    hidden, _ = _run_hidden(
        cfg, params, hidden, positions, kv, block_tables, kv_lens,
        block_size=block_size, fused_decode=hidden.shape[1] == 1,
    )
    return hidden, kv


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
