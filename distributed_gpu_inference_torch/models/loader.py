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

Mixtral's expert names load into the tree (``w_router``, ``we_*``), but
``TorchEngine`` does not serve MoE yet. Orbax checkpoints are JAX-only:
:func:`load_or_init_params` refuses any other directory by name.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from distributed_gpu_inference_torch.models import llama
from distributed_gpu_inference_torch.models.configs import ModelConfig
from distributed_gpu_inference_torch.ops.quantization import (
    QUANT_KEYS,
    QUANT_MODES,
    is_quantized,
    quantize_params,
    quantize_weight,
)
from distributed_gpu_inference_torch.utils.data_structures import BlockRange
from distributed_gpu_inference_torch.utils.safetensors import SafetensorsFile

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


class _Tree:
    """The stacked layer leaves as they fill, on ``device``: plain tensors
    in ``dtype``, or ``{"qw", "scale"}`` for the matmul weights when
    ``mode`` is set."""

    def __init__(self, num_layers: int, dtype: torch.dtype, device: torch.device,
                 mode: Optional[str]) -> None:
        self.L, self.dtype, self.device, self.mode = num_layers, dtype, device, mode
        self.layers: Dict[str, Any] = {}

    def _slot(self, key: str, shape: Tuple[int, ...]) -> Any:
        if key not in self.layers:
            full = (self.L, *shape)
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
        ``index``, quantizing it on the way for a quantized slot."""
        slot = self._slot(key, slot_shape)
        dest = slot["qw"] if is_quantized(slot) else slot
        want = tuple(dest.shape[len(index):])
        if tuple(w.shape) != want:
            raise ValueError(f"{name}: shape {tuple(w.shape)} (after the transpose) does "
                             f"not match {key}'s {want}")
        if is_quantized(slot):
            q = quantize_weight(w, self.mode)
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
) -> llama.Params:
    """Load a HF Llama-family checkpoint directory (safetensors shards) into
    the stacked params tree on ``device``. ``layer_range`` loads only
    layers ``[start, end)`` (a pipeline stage): the embedding only on the
    first stage, the final norm and the head only on the last (a tied head
    on a later stage still reads the embedding). ``quantization`` (int8 /
    fp8) quantizes every matmul weight slice as it is read."""
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

    tree = _Tree(rng.num_layers, dtype, device, quantization)
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


def load_or_init_params(
    cfg: ModelConfig,
    checkpoint_path: Optional[str | Path] = None,
    dtype: Optional[Any] = None,
    seed: int = 0,
    device: Any = "cuda",
    quantization: Optional[str] = None,
) -> llama.Params:
    """The engine's one weight source: an HF safetensors directory, or a
    random init from ``seed`` (``torch.Generator`` on ``device``; the
    full-precision tree is quantized leaf by leaf as it is consumed). Any
    other ``checkpoint_path`` is refused: the JAX package reads it as an
    orbax checkpoint, which is JAX-only."""
    dtype = llama.torch_dtype(dtype or cfg.dtype)
    if checkpoint_path:
        p = Path(checkpoint_path)
        # the JAX package's test: config.json or *.safetensors
        if (p / "config.json").exists() or any(p.glob("*.safetensors")):
            return load_hf_llama(p, cfg, dtype=dtype, device=device,
                                 quantization=quantization)
        raise ValueError(
            f"checkpoint_path {str(p)!r} is not an HF checkpoint directory (no "
            "config.json or *.safetensors); orbax checkpoints are JAX-only and "
            "the PyTorch port does not load them")
    gen = torch.Generator(device=device).manual_seed(seed)
    return quantize_params(llama.init_params(cfg, gen, dtype, device), quantization,
                           consume=True)
