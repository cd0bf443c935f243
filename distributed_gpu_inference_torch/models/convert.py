"""The weight bridge: numpy trees → the port's tensors.

``params_from_numpy`` takes a params pytree laid out exactly as the JAX
package's ``models/llama.py`` builds it — ``embedding [V, H]``, stacked
``layers`` leaves with a leading ``[L, ...]`` axis, ``final_norm [H]`` and
an optional untied ``lm_head [V, H]`` — given as numpy arrays, and returns
the same tree of torch tensors on ``device``. The layout is kept as it is,
so the port's ``forward_chunk`` reads the same leaves.

bf16 arrives as ``ml_dtypes.bfloat16`` arrays (what ``np.asarray`` of a
JAX bf16 array gives). It moves as raw 16-bit words — ``.view(np.uint16)``
into ``torch.from_numpy(...).view(torch.bfloat16)`` — never through f32,
so every weight is bit-identical on both sides. Quantized weights
(``{"qw", "scale"}`` leaves of ``ops/quantization.py``) move the same way:
int8 codes as they are, ``float8_e4m3fn`` codes as raw bytes, f32 scales.

KV pools: ``kv_from_numpy`` takes the JAX pools ``{"k", "v"}`` and, for
int8 pools, their scale pools ``{"k_scale", "v_scale"}`` ``[L, N, Bk, D]``
— the JAX package repeats each (page, token) scale over the D lanes. The
port keeps one scale per token (``[L, N, Bk]``): lane 0, after checking
that every lane agrees. ``kv_to_numpy`` expands it back, so wire formats
built from the port's pools stay byte-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_PLAIN_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint8): torch.uint8,
}


def array_to_tensor(arr: Any, device: Any = "cuda") -> torch.Tensor:
    """One numpy array (or anything ``np.asarray`` accepts) → a tensor on
    ``device`` with the same dtype and bits."""
    # a private, writable copy: JAX hands out read-only views, and the
    # tensor must not alias memory the caller still owns
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        words = arr.view(np.uint16)
        # torch.from_numpy has no uint16; int16 has the same width, so the
        # view carries the words unchanged
        t = torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
    elif arr.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(arr.view(np.uint8)).view(torch.float8_e4m3fn)
    elif arr.dtype in _PLAIN_DTYPES:
        t = torch.from_numpy(arr)
    else:
        raise TypeError(f"unsupported weight dtype {arr.dtype}")
    return t.to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits as numpy (bf16 as ``uint16`` words, fp8 as
    ``uint8`` bytes) — the inverse direction, for checking a round trip bit
    for bit."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def params_from_numpy(tree: Mapping[str, Any], device: Any = "cuda") -> Dict[str, Any]:
    """The JAX params pytree (numpy leaves) → the same tree of tensors,
    quantized ``{"qw", "scale"}`` leaves included."""
    out: Dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = params_from_numpy(leaf, device)
        else:
            out[name] = array_to_tensor(leaf, device)
    return out


def params_to_numpy(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`, leaves as raw bits
    (:func:`tensor_to_words`)."""
    return {name: (params_to_numpy(leaf) if isinstance(leaf, Mapping)
                   else tensor_to_words(leaf))
            for name, leaf in tree.items()}


def kv_from_numpy(pools: Mapping[str, Any], device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """KV pools ``{"k": [L, N, Hkv, Bk, D], "v": ...}`` (numpy) → tensors.
    int8 pools bring ``k_scale``/``v_scale`` ``[L, N, Bk, D]``; the port
    keeps lane 0 (``[L, N, Bk]``) after checking every lane carries the
    same scale."""
    out = {name: array_to_tensor(pools[name], device) for name in ("k", "v")}
    if ("k_scale" in pools) != ("v_scale" in pools):
        raise ValueError("int8 KV pools need both k_scale and v_scale")
    for name in ("k_scale", "v_scale"):
        if name not in pools:
            continue
        scale = np.asarray(pools[name])
        words = scale.view(np.uint16) if scale.dtype.itemsize == 2 else scale
        if not (words == words[..., :1]).all():
            raise ValueError(f"{name}: the lanes of a (page, token) scale differ")
        out[name] = array_to_tensor(scale[..., 0], device)
    return out


def kv_to_numpy(kv: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`kv_from_numpy` as raw bits: pools as they
    are, scale pools expanded over the head_dim lanes to ``[L, N, Bk,
    D]`` (the JAX package's layout)."""
    out = {name: tensor_to_words(kv[name]) for name in ("k", "v")}
    d = kv["k"].shape[-1]
    for name in ("k_scale", "v_scale"):
        if name in kv:
            words = tensor_to_words(kv[name])
            out[name] = np.ascontiguousarray(
                np.broadcast_to(words[..., None], (*words.shape, d)))
    return out
