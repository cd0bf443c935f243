"""Weight-only quantization: int8 / fp8 (e4m3) codes with one float32 scale
per output channel.

The port of ``distributed_gpu_inference_tpu/ops/quantization.py``. A
quantized weight is a dict ``{"qw": codes, "scale": f32}`` whose leaves
keep the stacked leading ``[L, ...]`` axis of the params tree: ``qw``
``[L, K, N]`` (int8 or ``float8_e4m3fn``), ``scale`` ``[L, 1, N]``. Codes
and scales are bit-identical to the JAX package's for the same float32
weights: ``torch.round`` rounds half to even like ``jnp.round``, the f32
divisions are IEEE on both sides, and :func:`to_float8_e4m3` reproduces
``astype(float8_e4m3fn)`` including its overflow to NaN.

:func:`matmul` is the one dispatch point every projection calls. A
quantized weight goes through the hand-written W8A16 kernel
(``ops/qmm.py``); a plain tensor is ``x @ w``.

The JAX package also has ``split_stacked_quant`` and ``matmul_stacked``.
They exist only because ``lax.scan`` slices every scanned leaf and a
Pallas custom call would then copy the slice each layer. The port loops
over layers in Python and slices a stacked leaf ``qw[layer]`` as a view,
with no copy, so ``forward_chunk`` hands ``{"qw": qw[layer], "scale":
scale[layer]}`` to :func:`matmul` and neither function is needed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from distributed_gpu_inference_torch.ops import qmm

QUANT_MODES = ("int8", "fp8")

# weight leaves eligible for quantization (matmul weights only: norms,
# biases and the embedding table stay high-precision)
QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
     "we_gate", "we_up", "we_down"}
)

FP8_MAX = 448.0          # float8_e4m3fn's largest finite value
# halfway between 448 and the next e4m3 step (480, which e4m3fn spends on
# NaN): larger magnitudes round past the format's range
_FP8_OVERFLOW = 464.0


def to_float8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Cast to ``float8_e4m3fn`` as JAX's ``astype`` does: round to
    nearest even, and any magnitude above 464 (infinities included) becomes
    a NaN of the input's sign. torch's own cast saturates there at ±448,
    so the overflow is set by hand."""
    codes = x.to(torch.float8_e4m3fn).view(torch.uint8)
    xf = x.float()
    nan_code = torch.where(xf < 0, 0xFF, 0x7F).to(torch.uint8)
    codes = torch.where(xf.abs() > _FP8_OVERFLOW, nan_code, codes)
    return codes.view(torch.float8_e4m3fn)


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` with JAX's rounding, for any storage dtype."""
    if dtype == torch.float8_e4m3fn:
        return to_float8_e4m3(x)
    return x.to(dtype)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "qw" in w and "scale" in w


def quantize_weight(w: torch.Tensor, mode: str) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel quantization of ``w [..., in, out]``:
    the scale reduces the contraction axis (-2) only, shape ``[..., 1,
    out]``."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; use {QUANT_MODES}")
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    one = torch.ones((), dtype=torch.float32, device=w.device)
    if mode == "int8":
        scale = torch.where(amax > 0, amax / 127.0, one)
        qw = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    else:
        scale = torch.where(amax > 0, amax / FP8_MAX, one)
        qw = to_float8_e4m3(wf / scale)
    return {"qw": qw, "scale": scale}


def dequantize(w: Dict[str, torch.Tensor], dtype: Any = torch.float32) -> torch.Tensor:
    return (w["qw"].float() * w["scale"]).to(dtype)


def _quantize_stacked(w: torch.Tensor, mode: str) -> Dict[str, torch.Tensor]:
    """Quantize a stacked ``[L, K, N]`` leaf one layer at a time: the scale
    reduces axis -2 only, so each layer slice quantizes on its own and the
    float32 temporaries stay one layer large (a whole llama3-8b ``w_gate``
    in f32 would be 7.5 GB)."""
    if w.dim() < 3:
        return quantize_weight(w, mode)
    code_dtype = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    qw = torch.empty(w.shape, dtype=code_dtype, device=w.device)
    scale = torch.empty((*w.shape[:-2], 1, w.shape[-1]), dtype=torch.float32,
                        device=w.device)
    for i in range(w.shape[0]):
        q = _quantize_stacked(w[i], mode)
        qw[i], scale[i] = q["qw"], q["scale"]
    return {"qw": qw, "scale": scale}


def quantize_params(
    params: Dict[str, Any], mode: Optional[str], consume: bool = False
) -> Dict[str, Any]:
    """Quantize every eligible matmul weight of a params tree; everything
    else is kept as it is. ``mode=None`` is the identity.

    ``consume=True`` pops each source leaf from ``params['layers']`` as its
    quantized replacement lands, so the peak is the full-precision tree
    plus one quantized leaf — what lets an int8 model cold-start near a
    card's capacity. The default leaves the caller's tree untouched."""
    if mode is None:
        return params
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; use {QUANT_MODES}")
    out = dict(params)
    src = params["layers"]
    new_layers: Dict[str, Any] = {}
    for k in list(src.keys()):
        v = src.pop(k) if consume else src[k]
        if k in QUANT_KEYS and not is_quantized(v):
            new_layers[k] = _quantize_stacked(v, mode)
            del v
        else:
            new_layers[k] = v
    out["layers"] = new_layers
    return out


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain tensor or a quantized dict of one
    layer (``qw [K, N]``, ``scale [1, N]``). A quantized weight runs
    through :func:`ops.qmm.qmm_w8a16` (f32 accumulation, the scale applied
    once to the sum) and comes back in x's dtype."""
    if not is_quantized(w):
        return x @ w
    k, n = w["qw"].shape[-2:]
    out = qmm.qmm_w8a16(x.reshape(-1, k).contiguous(), w["qw"], w["scale"])
    return out.reshape(*x.shape[:-1], n)
