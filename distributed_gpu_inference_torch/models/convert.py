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
so every weight is bit-identical on both sides.
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
    elif arr.dtype in _PLAIN_DTYPES:
        t = torch.from_numpy(arr)
    else:
        raise TypeError(f"unsupported weight dtype {arr.dtype}")
    return t.to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits as numpy (bf16 as ``uint16`` words) — the
    inverse direction, for checking a round trip bit for bit."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_numpy(tree: Mapping[str, Any], device: Any = "cuda") -> Dict[str, Any]:
    """The JAX params pytree (numpy leaves) → the same tree of tensors.
    Quantized ``{"qw", "scale"}`` weight leaves are not served by this
    slice of the port and are refused."""
    out: Dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            if "qw" in leaf and "scale" in leaf:
                raise NotImplementedError(
                    f"quantized weight {name!r}: int8/fp8 weights are not "
                    "ported yet"
                )
            out[name] = params_from_numpy(leaf, device)
        else:
            out[name] = array_to_tensor(leaf, device)
    return out


def kv_from_numpy(pools: Mapping[str, Any], device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """KV pools ``{"k": [L, N, Hkv, Bk, D], "v": ...}`` (numpy) → tensors.
    int8 pools with scale pools are not served by this slice."""
    if "k_scale" in pools or "v_scale" in pools:
        raise NotImplementedError("int8 KV pools are not ported yet")
    return {name: array_to_tensor(pools[name], device) for name in ("k", "v")}
