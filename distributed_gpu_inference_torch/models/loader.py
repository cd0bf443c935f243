"""Weight loading: HF Llama-family safetensors checkpoints → the params tree.

The port of ``distributed_gpu_inference_tpu/models/loader.py``
``load_hf_llama``, ``_validate`` and ``load_or_init_params``. HF names map
to the stacked layout the JAX package builds (``_HF_LAYER_MAP``): layer
weights stack on a leading ``[L, ...]`` axis, HF's ``[out, in]`` matmul
weights are transposed to ``[in, out]``, and the embedding, final norm and
untied head keep HF's layout. Files are read in ``sorted(glob)`` order and
``model.safetensors.index.json`` is not read, as in the JAX package. The
tree is bit-identical to the JAX loader's for the same files: the cast to
``dtype`` rounds to nearest even as ``astype`` does.

What differs is the memory plan. The JAX loader fills whole host arrays
(16 GB for llama3-8b) before any upload. Here each stacked leaf is
allocated on ``device`` and every layer slice is copied into its slot as
it is read (``utils/safetensors.py`` maps the file, so a slice costs no
host memory until it moves). With ``quantization`` each slice of a matmul
weight is quantized as it arrives (``ops/quantization.py``
``quantize_weight``, whose scale reduces one slice at a time), so the
full-precision leaf is never built: the peak on the card is the quantized
tree plus one slice and its f32 temporaries. Codes and scales are
bit-identical to ``quantize_params`` of the full-precision tree.

Like the JAX loader, ``_validate`` checks the key set and the layer count
only: a layer tensor missing from the checkpoint loads as zeros (codes 0
and scale 1 when quantized, which is what quantizing zeros gives).

Mixtral's expert names load into the tree (``w_router``, ``we_*``).
:func:`load_hf_vit` reads an HF ViT checkpoint into the vision engine's
encoder tree. Orbax checkpoints are JAX-only: :func:`load_or_init_params` refuses any
other directory by name.

A random init whose full-precision tree does not fit the device is drawn
already quantized (:func:`init_quantized_streamed`, the port of the JAX
loader's function of that name): one f32 layer slice at a time, quantized
into preallocated codes and scales. :func:`init_route` is the rule that
picks it, on the device's total memory (not its free memory, so a model
draws the same weights whatever else is resident). A full-precision tree
larger than the device is refused before anything is allocated.

The quantized-weight cache (``EngineConfig.quant_cache_dir``, the port's
own format in place of the JAX engine's orbax directory): after a quantized
build the tree is written as one safetensors file
(:func:`save_quant_cache`: int8 / e4m3 codes as ``I8`` / ``F8_E4M3``, their
scales, and the full-precision leaves, each under its path in the tree),
named by :func:`quant_cache_path` as the JAX engine names its cache:
``<model>-<quantization>-<dtype>-<source>-seed<seed>``, the source a
signature over the checkpoint's files (name, size, ``mtime_ns``, walked
recursively) or ``rand``. :func:`load_quant_cache` maps it and copies each
tensor straight to the device with no quantization pass; a file it cannot
read (truncated, corrupt, another tree) is logged and rebuilt.
"""

from __future__ import annotations

import hashlib
import logging
import re
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from distributed_gpu_inference_torch.models import llama
from distributed_gpu_inference_torch.models.configs import ModelConfig
from distributed_gpu_inference_torch.ops.quantization import (
    QUANT_KEYS,
    QUANT_MODES,
    is_quantized,
    quantize_weight,
)
from distributed_gpu_inference_torch.parallel.sharding import (
    cut,
    cut_quantized_at,
    expert_range,
    leaf_axis,
    scale_axis,
)
from distributed_gpu_inference_torch.utils.data_structures import BlockRange
from distributed_gpu_inference_torch.utils.safetensors import (
    SafetensorsFile,
    write_safetensors,
)

# HF parameter name → (our key, needs_transpose); the layer index is
# captured by _LAYER_RE and our layout stacks layers on a leading axis
_HF_LAYER_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    # Qwen2-style attention biases (absent in Llama checkpoints)
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")

# HF Mixtral MoE naming: block_sparse_moe.gate (router) and per-expert
# w1 (gate), w3 (up), w2 (down) projections
_MOE_GATE_KEY = "block_sparse_moe.gate.weight"
_MOE_EXPERT_RE = re.compile(r"^block_sparse_moe\.experts\.(\d+)\.(w[123])\.weight$")
_MOE_EXPERT_MAP = {"w1": "we_gate", "w3": "we_up", "w2": "we_down"}

_EMBED = "model.embed_tokens.weight"

# f32 elements of one quantize step of the streamed init: its temporaries
# stay a few hundred MB beside the layer slice being quantized
_QUANT_CHUNK = 1 << 24

log = logging.getLogger(__name__)


class _Tree:
    """The stacked layer leaves as they fill, on ``device``: plain tensors
    in ``dtype``, or ``{"qw", "scale"}`` for the matmul weights when
    ``mode`` is set. With ``shard=(rank, tp)`` only rank ``rank``'s part
    of each leaf is allocated and filled (``parallel/sharding.py``): a
    slice is quantized whole, then cut."""

    def __init__(self, num_layers: int, dtype: torch.dtype, device: torch.device,
                 mode: Optional[str], shard: Optional[Tuple[int, int]] = None) -> None:
        self.L, self.dtype, self.device, self.mode = num_layers, dtype, device, mode
        self.rank, self.tp = shard or (0, 1)
        self.layers: Dict[str, Any] = {}

    def _slot(self, key: str, shape: Tuple[int, ...]) -> Any:
        if key not in self.layers:
            full = [self.L, *shape]
            axis = leaf_axis(key)
            if axis is not None:
                full[axis] //= self.tp
            full = tuple(full)
            if self.mode is not None and key in QUANT_KEYS:
                code = torch.int8 if self.mode == "int8" else torch.float8_e4m3fn
                self.layers[key] = {
                    "qw": torch.zeros(full, dtype=code, device=self.device),
                    "scale": torch.ones((*full[:-2], 1, full[-1]), dtype=torch.float32,
                                        device=self.device),
                }
            else:
                self.layers[key] = torch.zeros(full, dtype=self.dtype, device=self.device)
        return self.layers[key]

    def put(self, key: str, index: Tuple[int, ...], slot_shape: Tuple[int, ...],
            w: torch.Tensor, name: str) -> None:
        """Write one slice (already in ``dtype``, on the device) at
        ``index``, quantizing it on the way for a quantized slot, and
        keeping the shard's part of it."""
        slot = self._slot(key, slot_shape)
        axis = leaf_axis(key)
        q = None
        if axis is not None and self.tp > 1:
            if axis < len(index):
                # the cut axis is one of the index's (a MoE expert): the
                # slice is the rank's or none of its business
                lo, hi = expert_range(slot_shape[axis - 1], self.rank, self.tp)
                if not lo <= index[axis] < hi:
                    return
                index = (*index[:axis], index[axis] - lo, *index[axis + 1:])
            elif is_quantized(slot):
                q = cut_quantized_at(quantize_weight(w, self.mode), axis - len(index),
                                     self.rank, self.tp)
            else:
                w = cut(w, axis - len(index), self.rank, self.tp)
        dest = slot["qw"] if is_quantized(slot) else slot
        want = tuple(dest.shape[len(index):])
        got = tuple((q["qw"] if q is not None else w).shape)
        if got != want:
            raise ValueError(f"{name}: shape {got} (after the transpose and the cut) "
                             f"does not match {key}'s {want}")
        if is_quantized(slot):
            q = q if q is not None else quantize_weight(w, self.mode)
            slot["qw"][index] = q["qw"]
            slot["scale"][index] = q["scale"]
        else:
            slot[index] = w


def load_hf_llama(
    model_dir: str | Path,
    cfg: ModelConfig,
    dtype: Optional[Any] = None,
    layer_range: Optional[BlockRange] = None,
    device: Any = "cuda",
    quantization: Optional[str] = None,
    shard: Optional[Tuple[int, int]] = None,
) -> llama.Params:
    """Load a HF Llama-family checkpoint directory (safetensors shards) into
    the stacked params tree on ``device``. ``layer_range`` loads only
    layers ``[start, end)`` (a pipeline stage): the embedding only on the
    first stage, the final norm and the head only on the last (a tied head
    on a later stage still reads the embedding). ``quantization`` (int8 /
    fp8) quantizes every matmul weight slice as it is read. ``shard=(rank,
    tp)`` keeps rank ``rank``'s tensor-parallel part of each slice (a slice
    is quantized whole, then cut)."""
    if quantization is not None and quantization not in QUANT_MODES:
        raise ValueError(f"unknown quantization {quantization!r}; use {QUANT_MODES}")
    model_dir = Path(model_dir)
    dtype = llama.torch_dtype(dtype or cfg.dtype)
    device = torch.device(device)
    rng = layer_range or BlockRange(0, cfg.num_layers)
    first_stage = rng.start == 0
    last_stage = rng.end == cfg.num_layers

    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")

    def read(st: SafetensorsFile, name: str, transpose: bool = False) -> torch.Tensor:
        # the raw bytes move to the device in the checkpoint's dtype; the
        # transpose and the cast (round to nearest even) run there
        w = st.get_tensor(name).to(device, copy=True)
        return (w.t() if transpose else w).to(dtype)

    tree = _Tree(rng.num_layers, dtype, device, quantization, shard)
    params: Dict[str, Any] = {"layers": tree.layers}
    for f in files:
        with SafetensorsFile(f) as st:
            for name in st.keys():
                m = _LAYER_RE.match(name)
                if m:
                    li = int(m.group(1))
                    if li not in rng:
                        continue
                    sub = m.group(2)
                    em = _MOE_EXPERT_RE.match(sub)
                    if em:  # Mixtral expert: stacked on [L, E, in, out]
                        w = read(st, name, transpose=True)
                        tree.put(_MOE_EXPERT_MAP[em.group(2)], (li - rng.start, int(em.group(1))),
                                 (cfg.num_experts, *w.shape), w, name)
                        continue
                    if sub == _MOE_GATE_KEY:  # router [E, H] → [H, E]
                        w = read(st, name, transpose=True)
                        tree.put("w_router", (li - rng.start,), tuple(w.shape), w, name)
                        continue
                    if sub not in _HF_LAYER_MAP:
                        continue
                    our_key, transpose = _HF_LAYER_MAP[sub]
                    w = read(st, name, transpose)
                    tree.put(our_key, (li - rng.start,), tuple(w.shape), w, name)
                elif name == _EMBED and first_stage:
                    params["embedding"] = read(st, name)
                elif name == "model.norm.weight" and last_stage:
                    params["final_norm"] = read(st, name)
                elif name == "lm_head.weight" and last_stage and not cfg.tie_word_embeddings:
                    params["lm_head"] = read(st, name)

    if cfg.tie_word_embeddings and last_stage and not first_stage:
        # a tied head on a non-first stage still needs the embedding
        # matrix; multi-file checkpoints store it in any shard
        for f in files:
            with SafetensorsFile(f) as st:
                if _EMBED in st.keys():
                    params["embedding"] = read(st, _EMBED)
                    break
    _validate(params, cfg, rng)
    return params


# HF ViT encoder-layer name → (our key, needs_transpose); q/k/v fuse
# into ``wqkv``/``bqkv`` separately
_HF_VIT_LAYER_MAP = {
    "layernorm_before.weight": ("norm1", False),
    "layernorm_before.bias": ("norm1_b", False),
    "attention.output.dense.weight": ("wo", True),
    "attention.output.dense.bias": ("bo", False),
    "layernorm_after.weight": ("norm2", False),
    "layernorm_after.bias": ("norm2_b", False),
    "intermediate.dense.weight": ("w1", True),
    "intermediate.dense.bias": ("b1", False),
    "output.dense.weight": ("w2", True),
    "output.dense.bias": ("b2", False),
}
_VIT_LAYER_RE = re.compile(r"^vit\.encoder\.layer\.(\d+)\.(.+)$")
_VIT_QKV_RE = re.compile(r"^attention\.attention\.(query|key|value)\.(weight|bias)$")
_VIT_QKV_IDX = {"query": 0, "key": 1, "value": 2}
_VIT_PATCH = "vit.embeddings.patch_embeddings.projection."
_VIT_TOP = {_VIT_PATCH + "bias": "patch_bias", "vit.layernorm.weight": "out_norm",
            "vit.layernorm.bias": "out_norm_b"}


def load_hf_vit(model_dir: str | Path, cfg: Any, dtype: Optional[Any] = None,
                head_seed: int = 0, device: Any = "cuda") -> Dict[str, Any]:
    """An HF ViT-class safetensors checkpoint (google/vit-* layout) → the
    :mod:`models.vit` params tree on ``device`` (the port of the JAX
    loader's ``load_hf_vit``, read through ``utils/safetensors.py``).

    Imported exactly: the patch projection (the conv kernel ``[H, C, P,
    P]`` laid out as patchify's ``[P·P·C, H]``), the position embeddings
    without the CLS slot, every encoder layer with all its biases, and the
    final LayerNorm. Not imported, by design: the CLS token and the
    ``query_emb``/``out_proj`` resampler head, drawn fresh from a
    ``torch.Generator`` seeded with ``head_seed`` (not JAX's threefry
    draws). Every (tensor, layer) slot must be filled from the checkpoint;
    the JAX loader's validation errors are raised here with its
    messages."""
    from distributed_gpu_inference_torch.models.encoder_common import fan_in_init

    model_dir = Path(model_dir)
    dtype = llama.torch_dtype(dtype or "float32")
    L, h = cfg.num_layers, cfg.hidden_size
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")

    layers: Dict[str, torch.Tensor] = {}
    qkv_w = torch.zeros((L, 3, h, h), dtype=torch.float32)
    qkv_b = torch.zeros((L, 3, h), dtype=torch.float32)
    params: Dict[str, Any] = {}
    filled: set = set()
    for f in files:
        with SafetensorsFile(f) as st:
            for name in st.keys():
                m = _VIT_LAYER_RE.match(name)
                if m:
                    li, sub = int(m.group(1)), m.group(2)
                    if li >= L:
                        raise ValueError(
                            f"checkpoint layer {li} exceeds config num_layers={L}")
                    qm = _VIT_QKV_RE.match(sub)
                    if qm:
                        idx = _VIT_QKV_IDX[qm.group(1)]
                        w = st.get_tensor(name).float()
                        if qm.group(2) == "weight":
                            qkv_w[li, idx] = w.t()      # HF stores [out, in]
                        else:
                            qkv_b[li, idx] = w
                        filled.add((f"{qm.group(1)}.{qm.group(2)}", li))
                        continue
                    if sub not in _HF_VIT_LAYER_MAP:
                        continue
                    key, transpose = _HF_VIT_LAYER_MAP[sub]
                    w = st.get_tensor(name)
                    if transpose:
                        w = w.t()
                    if key not in layers:
                        layers[key] = torch.zeros((L, *w.shape), dtype=dtype)
                    layers[key][li] = w.to(dtype)
                    filled.add((key, li))
                elif name == _VIT_PATCH + "weight":
                    # conv kernel [H, C, P, P] → patchify's (row, col,
                    # channel) flattening → [P*P*C, H]
                    w = st.get_tensor(name).permute(2, 3, 1, 0)
                    params["patch_proj"] = w.reshape(-1, w.shape[-1]).to(dtype)
                elif name == "vit.embeddings.position_embeddings":
                    # [1, 1+N, H]: slot 0 is the CLS position, dropped
                    params["pos_emb"] = st.get_tensor(name)[0, 1:].to(dtype)
                elif name in _VIT_TOP:
                    params[_VIT_TOP[name]] = st.get_tensor(name).to(dtype)

    # wqkv columns in q | k | v order: [L, 3, in, out] → [L, in, 3·out]
    layers["wqkv"] = qkv_w.permute(0, 2, 1, 3).reshape(L, h, 3 * h).to(dtype)
    layers["bqkv"] = qkv_b.reshape(L, 3 * h).to(dtype)
    missing = {"patch_proj", "pos_emb", "out_norm"} - set(params)
    if missing:
        raise ValueError(f"checkpoint is missing ViT tensors: {missing}")
    expected = ({v[0] for v in _HF_VIT_LAYER_MAP.values()}
                | {f"{q}.{t}" for q in _VIT_QKV_IDX for t in ("weight", "bias")})
    gaps = sorted((k, li) for k in expected for li in range(L) if (k, li) not in filled)
    if gaps:
        raise ValueError(
            f"checkpoint left {len(gaps)} encoder tensors unfilled "
            f"(missing shard / shallower model?): first few {gaps[:4]}")
    if params["pos_emb"].shape[0] != cfg.num_patches:
        raise ValueError(
            f"position embeddings cover {params['pos_emb'].shape[0]} "
            f"patches, config expects {cfg.num_patches} "
            f"(image {cfg.image_size} / patch {cfg.patch_size})")

    device = torch.device(device)
    params = {k: v.to(device) for k, v in params.items()}
    params["layers"] = {k: v.to(device) for k, v in layers.items()}
    # the resampler head: fresh (trained against the paired decoder)
    gen = torch.Generator(device=device).manual_seed(head_seed)
    params["query_emb"] = fan_in_init(gen, (cfg.num_prefix, h), h, dtype)
    params["out_proj"] = fan_in_init(gen, (h, cfg.out_dim), h, dtype)
    return params


def _validate(params: Dict[str, Any], cfg: ModelConfig, rng: BlockRange) -> None:
    """The JAX loader's checks and messages: the layer key set, the layer
    count, and the embedding and final norm of the stages that own them."""
    expected = set(_HF_LAYER_MAP[k][0] for k in _HF_LAYER_MAP)
    if not cfg.attention_bias:  # Llama-family checkpoints carry no biases
        expected -= {"bq", "bk", "bv"}
    if cfg.num_experts:  # Mixtral: sparse expert MLP instead of dense
        expected -= {"w_gate", "w_up", "w_down"}
        expected |= {"w_router", "we_gate", "we_up", "we_down"}
    got = set(params["layers"].keys())
    if got != expected:
        missing, extra = expected - got, got - expected
        parts = []
        if missing:
            parts.append(f"missing {sorted(missing)}")
        if extra:
            hint = (
                " (a biased checkpoint needs a config with "
                "attention_bias=True)"
                if extra <= {"bq", "bk", "bv"} else ""
            )
            parts.append(f"unexpected {sorted(extra)}{hint}")
        raise ValueError("checkpoint layer params: " + "; ".join(parts))
    L = rng.num_layers
    for k, v in params["layers"].items():
        n = (v["qw"] if is_quantized(v) else v).shape[0]
        if n != L:
            raise ValueError(f"{k}: expected {L} layers, got {n}")
    if rng.start == 0 and "embedding" not in params:
        raise ValueError("first stage missing embedding")
    if rng.end == cfg.num_layers and "final_norm" not in params:
        raise ValueError("last stage missing final_norm")


def _quantize_into(w: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                   mode: str) -> None:
    """``quantize_weight(w, mode)`` written into ``qw`` / ``scale``, a
    matrix and a block of its columns at a time: the scale reduces the
    contraction axis only, so every column quantizes on its own and the
    codes and scales are those of one call on the whole of ``w``."""
    k, n = w.shape[-2:]
    w3, q3, s3 = w.reshape(-1, k, n), qw.view(-1, k, n), scale.view(-1, 1, n)
    cols = max(1, _QUANT_CHUNK // k)
    for i in range(w3.shape[0]):
        for c0 in range(0, n, cols):
            q = quantize_weight(w3[i, :, c0:c0 + cols], mode)
            q3[i, :, c0:c0 + cols] = q["qw"]
            s3[i, :, c0:c0 + cols] = q["scale"]
            del q


def init_quantized_streamed(
    cfg: ModelConfig,
    mode: str,
    dtype: Optional[Any] = None,
    seed: int = 0,
    device: Any = "cuda",
    shard: Optional[Tuple[int, int]] = None,
) -> llama.Params:
    """Random-init a model on ``device`` already quantized, one layer slice
    at a time: the cold start of a model whose full-precision tree exceeds
    the device (mixtral-8x7b in bf16 is 93.4 GB). The port of the JAX
    loader's ``init_quantized_streamed``, with the same tree layout.

    Each matmul leaf ``[L, ...]`` is drawn slice by slice in f32 on the
    device from a ``torch.Generator`` keyed by ``seed`` and the leaf's name
    (its crc32, as the JAX package keys it), quantized with
    ``quantize_weight`` a block of columns at a time and written into
    preallocated codes and scales. Norms, router, embedding and head are
    drawn in the model dtype. The peak is the quantized tree plus one f32
    layer slice (``[E, H, I]`` for an expert leaf: 1.88 GB for
    mixtral-8x7b) and a few hundred MB of quantize temporaries. The values
    differ from ``llama.init_params``'s, as they do in JAX: only
    determinism in the seed matters.

    ``shard=(rank, tp)``: rank ``rank``'s tensor-parallel part, each slice
    drawn and quantized whole as above, then cut (the dense leaves by
    ``llama.normal_leaf``'s sharded draw)."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization {mode!r}; use {QUANT_MODES}")
    dtype = llama.torch_dtype(dtype or cfg.dtype)
    device = torch.device(device)
    h, d = cfg.hidden_size, cfg.head_dim
    nh, nkv, i = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    L, v = cfg.num_layers, cfg.vocab_size
    code = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    rank, tp = shard or (0, 1)

    def _gen(name: str) -> torch.Generator:
        key = (seed << 31) + (zlib.crc32(name.encode()) & 0x7FFFFFFF)
        return torch.Generator(device=device).manual_seed(key % (1 << 64))

    def _q_leaf(name: str, shape: Tuple[int, ...], fan_in: int) -> Dict[str, torch.Tensor]:
        g = _gen(name)
        # a whole slice's codes and scales, cut on the slice's axis (the
        # leaf's, less the layer axis) once quantized
        whole = {"qw": torch.empty(shape, dtype=code, device=device),
                 "scale": torch.empty((*shape[:-2], 1, shape[-1]), dtype=torch.float32,
                                      device=device)}
        axis = leaf_axis(name) - 1
        part = cut_quantized_at(whole, axis, rank, tp)
        qw = torch.empty((L, *part["qw"].shape), dtype=code, device=device)
        scale = torch.empty((L, *part["scale"].shape), dtype=torch.float32, device=device)
        for layer in range(L):
            # one f32 slice, scaled in place
            w = torch.randn(shape, generator=g, device=device,
                            dtype=torch.float32).mul_(fan_in ** -0.5)
            _quantize_into(w, whole["qw"], whole["scale"], mode)
            del w
            part = cut_quantized_at(whole, axis, rank, tp)
            qw[layer], scale[layer] = part["qw"], part["scale"]
        return {"qw": qw, "scale": scale}

    def _dense_leaf(name: str, shape: Tuple[int, ...], fan_in: int) -> torch.Tensor:
        return llama.normal_leaf(shape, fan_in, _gen(name), dtype, device, name, shard)

    norm_init = torch.zeros if cfg.norm_offset else torch.ones
    layers: Dict[str, Any] = {
        "attn_norm": norm_init((L, h), dtype=dtype, device=device),
        "mlp_norm": norm_init((L, h), dtype=dtype, device=device),
    }
    leaf_specs = {
        "wq": ((h, nh * d), h),
        "wk": ((h, nkv * d), h),
        "wv": ((h, nkv * d), h),
        "wo": ((nh * d, h), nh * d),
    }
    if cfg.num_experts:
        e = cfg.num_experts
        layers["w_router"] = _dense_leaf("w_router", (L, h, e), h)
        leaf_specs.update({"we_gate": ((e, h, i), h), "we_up": ((e, h, i), h),
                           "we_down": ((e, i, h), i)})
    else:
        leaf_specs.update({"w_gate": ((h, i), h), "w_up": ((h, i), h),
                           "w_down": ((i, h), i)})
    for name, (shape, fan_in) in leaf_specs.items():
        layers[name] = _q_leaf(name, shape, fan_in)
    if cfg.attention_bias:
        layers["bq"] = _dense_leaf("bq", (L, nh * d), nh * d)
        layers["bk"] = _dense_leaf("bk", (L, nkv * d), nkv * d)
        layers["bv"] = _dense_leaf("bv", (L, nkv * d), nkv * d)
    params: Dict[str, Any] = {
        "embedding": _dense_leaf("embedding", (v, h), h),
        "layers": layers,
        "final_norm": norm_init((h,), dtype=dtype, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _dense_leaf("lm_head", (v, h), h)
    return params


def device_total_bytes(device: Any) -> Optional[int]:
    """The device's total memory, or None where there is no bound to hold
    a tree to (the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def init_route(cfg: ModelConfig, dtype: Any, quantization: Optional[str],
               device: Any) -> str:
    """How a random init of ``cfg`` is built on ``device``: ``"full"``
    (``llama.init_params``, each matmul weight quantized as it is drawn if
    asked) or
    ``"streamed"`` (:func:`init_quantized_streamed`), taken for a
    quantized init whose full-precision tree exceeds the device's total
    memory. A full-precision tree that exceeds it with no quantization is
    refused with its size."""
    fp_bytes = cfg.param_bytes(llama.torch_dtype(dtype or cfg.dtype).itemsize)
    total = device_total_bytes(device)
    if total is None or fp_bytes <= total:
        return "full"
    if quantization is None:
        raise ValueError(
            f"{cfg.name}: its {llama.torch_dtype(dtype or cfg.dtype)} weights take "
            f"{fp_bytes / 1e9:.1f} GB, more than the device's {total / 1e9:.1f} GB; "
            f"load it quantized (quantization: int8 or fp8)")
    return "streamed"


def load_or_init_params(
    cfg: ModelConfig,
    checkpoint_path: Optional[str | Path] = None,
    dtype: Optional[Any] = None,
    seed: int = 0,
    device: Any = "cuda",
    quantization: Optional[str] = None,
    shard: Optional[Tuple[int, int]] = None,
) -> llama.Params:
    """The engine's one weight source: an HF safetensors directory, or a
    random init from ``seed`` on ``device`` by :func:`init_route`'s rule
    (the full-precision tree from a ``torch.Generator``, quantized leaf by
    leaf as it is consumed, or the streamed quantized init). Any other
    ``checkpoint_path`` is refused: the JAX package reads it as an orbax
    checkpoint, which is JAX-only. A full-precision tree larger than the
    device is refused before anything is allocated.

    ``shard=(rank, tp)``: only rank ``rank``'s tensor-parallel part lands
    on ``device``, holding the values of the whole tree's, cut: the route
    is chosen as for the whole tree, every leaf (or streamed slice) is
    drawn as the whole tree draws it, and a weight is quantized whole
    before the cut."""
    dtype = llama.torch_dtype(dtype or cfg.dtype)
    if quantization is not None and quantization not in QUANT_MODES:
        raise ValueError(f"unknown quantization {quantization!r}; use {QUANT_MODES}")
    route = init_route(cfg, dtype, quantization, device)
    if checkpoint_path:
        p = Path(checkpoint_path)
        # the JAX package's test: config.json or *.safetensors
        if (p / "config.json").exists() or any(p.glob("*.safetensors")):
            return load_hf_llama(p, cfg, dtype=dtype, device=device,
                                 quantization=quantization, shard=shard)
        raise ValueError(
            f"checkpoint_path {str(p)!r} is not an HF checkpoint directory (no "
            "config.json or *.safetensors); orbax checkpoints are JAX-only and "
            "the PyTorch port does not load them")
    log.info("%s: random init from seed %d, route %s", cfg.name, seed, route)
    if route == "streamed":
        return init_quantized_streamed(cfg, quantization, dtype, seed, device, shard)
    gen = torch.Generator(device=device).manual_seed(seed)
    return llama.init_params(cfg, gen, dtype, device, shard=shard,
                             quantization=quantization)


# ---------------------------------------------------------------- quantized-weight cache

#: the cache file's ``__metadata__["format"]``
QUANT_CACHE_FORMAT = "quantized-params/1"


def quant_cache_path(cache_dir: str | Path, model_name: str, quantization: str,
                     dtype: str, checkpoint_path: Optional[str | Path],
                     seed: int) -> Path:
    """The cache file of one quantized tree: ``<cache_dir>/<tag>.safetensors``
    with the JAX engine's tag. The source part is a content signature of the
    checkpoint directory, not its path, so a checkpoint rewritten in place
    gets a new file instead of the previous model's tree."""
    if checkpoint_path is None:
        src = "rand"
    else:
        p = Path(checkpoint_path)
        sig = hashlib.sha1()
        for f in sorted(p.rglob("*")):
            try:
                st = f.stat()
            except OSError:
                continue
            sig.update(f"{f.name}:{st.st_size}:{st.st_mtime_ns};".encode())
        src = f"{p.name or 'ckpt'}-{sig.hexdigest()[:10]}"
    return Path(cache_dir) / f"{model_name}-{quantization}-{dtype}-{src}-seed{seed}.safetensors"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def save_quant_cache(path: str | Path, params: Dict[str, Any]) -> int:
    """Write a quantized tree to its cache file (renamed into place). →
    bytes written, 0 when it could not be written (logged: the cache is
    best-effort and serving goes on with the tree it has)."""
    path = Path(path)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        return write_safetensors(path, _flatten(params), {"format": QUANT_CACHE_FORMAT})
    except OSError as exc:
        log.warning("cannot write the quantized-weight cache %s: %s", path, exc)
        return 0


def _cut_cached(name: str, t: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """A cache file's tensor ``name`` (its path in the tree) cut to rank
    ``rank``'s part: a quantized leaf's ``qw`` by its weight's rule, its
    ``scale`` by the same axis where the scale has it at full size."""
    *_, parent, leaf = ["", *name.split("/")]
    axis = leaf_axis(parent if leaf in ("qw", "scale") else leaf)
    return cut(t, scale_axis(axis, t) if leaf == "scale" else axis, rank, tp)


def load_quant_cache(path: str | Path, cfg: ModelConfig, device: Any,
                     shard: Optional[Tuple[int, int]] = None
                     ) -> Optional[Dict[str, Any]]:
    """The tree of a cache file, each tensor copied from the mapped file
    straight to ``device``; None when there is no file, or when it cannot be
    read or does not hold a tree of ``cfg`` (logged: the caller rebuilds
    and rewrites it). ``shard=(rank, tp)``: each tensor is cut to rank
    ``rank``'s part in the mapped file, and only that part is copied."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        with SafetensorsFile(path) as f:
            if (f.metadata() or {}).get("format") != QUANT_CACHE_FORMAT:
                raise ValueError("not a quantized-params cache file")
            tree: Dict[str, Any] = {}
            for name in f.keys():
                *parents, leaf = name.split("/")
                node = tree
                for part in parents:
                    node = node.setdefault(part, {})
                t = f.get_tensor(name)
                if shard is not None:
                    t = _cut_cached(name, t, *shard)
                node[leaf] = t.to(device)
        layers = tree.get("layers") or {}
        if not layers or any(int(t.shape[0]) != cfg.num_layers
                             for t in _flatten(layers).values()):
            raise ValueError(f"does not hold {cfg.num_layers} layers of {cfg.name}")
        return tree
    except (OSError, ValueError, KeyError, RuntimeError) as exc:
        log.warning("quantized-weight cache %s is unreadable (%s): rebuilding it", path, exc)
        return None
