"""The C++ radix index (``src/radix_index.cpp``) behind the interface of
``runtime.kv_cache.RadixPrefixIndex``: the block manager takes either
from ``runtime.kv_cache.make_radix_index``."""

from __future__ import annotations

import ctypes
from array import array
from typing import List, Sequence

import numpy as np

from distributed_gpu_inference_torch.native import get_lib

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _as_i32(token_ids: Sequence[int]):
    """(the buffer to keep alive, its int32 pointer, its length): no copy
    for an int32 numpy array, one C-level pass for a Python list."""
    if isinstance(token_ids, np.ndarray):
        a = np.ascontiguousarray(token_ids, dtype=np.int32)
        return a, a.ctypes.data_as(_I32P), a.size
    a = array("i", token_ids)
    if not len(a):
        return a, None, 0
    ptr = (ctypes.c_int32 * len(a)).from_buffer(a)
    return a, ctypes.cast(ptr, _I32P), len(a)


class NativeRadixPrefixIndex:
    """The prefix index in C++. Token and block sequences cross the ABI
    as buffers converted in bulk (a per-element ctypes call costs more
    than the traversal saves); an int32 numpy array crosses without a
    copy."""

    native = True

    def __init__(self, block_size: int) -> None:
        lib = get_lib()
        if lib is None:
            raise RuntimeError("the native library is unavailable")
        self._lib = lib
        self.block_size = block_size
        self._h = lib.radix_new(block_size)
        if not self._h:
            raise RuntimeError(f"radix_new({block_size}) failed")

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            try:
                lib.radix_destroy(h)
            except Exception:  # noqa: BLE001
                pass
            self._h = None

    def match_prefix(self, token_ids: Sequence[int]) -> List[int]:
        keep, ptr, n = _as_i32(token_ids)
        max_out = max(1, n // self.block_size)
        out = np.empty(max_out, dtype=np.int64)
        got = self._lib.radix_match(self._h, ptr, n, out.ctypes.data_as(_I64P), max_out)
        del keep
        return out[:got].tolist()

    def insert(self, token_ids: Sequence[int], block_ids: Sequence[int]) -> int:
        keep, ptr, n = _as_i32(token_ids)
        blocks = np.ascontiguousarray(block_ids, dtype=np.int64)
        added = int(self._lib.radix_insert(self._h, ptr, n, blocks.ctypes.data_as(_I64P),
                                           blocks.size))
        del keep
        return added

    def contains_block(self, block_id: int) -> bool:
        return bool(self._lib.radix_contains(self._h, int(block_id)))

    def is_leaf(self, block_id: int) -> bool:
        return bool(self._lib.radix_is_leaf(self._h, int(block_id)))

    def remove_block(self, block_id: int) -> None:
        if self._lib.radix_remove(self._h, int(block_id)) == -1:
            raise ValueError(f"cannot evict interior radix block {block_id}")

    def __len__(self) -> int:
        return int(self._lib.radix_size(self._h))
