"""The serving path's two attention kernels: wrappers, plain versions and
launch counters.

- :func:`ragged_paged_attention` — one launch over a ragged row batch
  (decode rows, prefill-chunk rows and pad rows together) against one
  layer's paged pool. CUDA source: ``csrc/ragged_paged_attention.cu``;
  replaces the Pallas kernel ``_ragged_kernel`` (JAX package,
  ``ops/paged_attention_pallas.py`` ``ragged_paged_attention``).
- :func:`paged_decode_attention_fused` — one layer's decode step on the
  stacked pools: write each active row's new K/V into its page slot, then
  attend the row's query over the updated context. CUDA source:
  ``csrc/paged_decode_fused.cu``; replaces the Pallas kernel
  ``_decode_kernel`` (``_call_decode_kernel``). The pools are updated in
  place where the JAX package aliased them.

Both take bf16 queries over a bf16, int8 or fp8 (e4m3) pool. An int8
pool comes with its scale pools (``k_scale``/``v_scale``: one bf16 scale
per (page, token), ``[N, Bk]`` for one layer, ``[L, N, Bk]`` stacked; the
contract is ``ops.attention.quantize_token_rows``); the fused kernel
quantizes the new row itself and writes its scale in place.

The fused decode kernel splits each row's keys over blocks by
:func:`kv_split_plan` (whole pages a split, planned from the table width
and block size alone) and merges the splits' partial softmax states in
split order in a second launch; the wrapper allocates that workspace. It
reads no device tensor on the host, so both wrappers can be captured in a
CUDA graph.

On a CUDA tensor a wrapper launches its kernel or raises; it takes the
plain version only because the tensor it was given lies on the CPU. What
the kernels take (:func:`kernel_takes`: head_dim 32/64/128/256, bf16
activations, bf16/int8/fp8 pools) the engine checks when it loads a model
on the card, so a model they do not take is refused there. Each
wrapper counts its calls that launch in ``<wrapper>.launches`` — one per
call (a split call's merge launch is part of it) and nowhere else — so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from distributed_gpu_inference_torch.ops import _build
from distributed_gpu_inference_torch.ops.qmm import qmm_w8a16
from distributed_gpu_inference_torch.ops.attention import (
    paged_attention_ref,
    write_kv_pages,
    write_quantized_kv,
)

_HEAD_DIMS = (32, 64, 128, 256)
_POOL_DTYPES = {torch.bfloat16: "bf16", torch.int8: "int8",
                torch.float8_e4m3fn: "fp8"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ragged_paged_attention": (
        [_P, _P, _P, _P, _P,                    # q, k, v, k_scale, v_scale
         _P, _P, _P, _P,                        # tables, pos, lens, out
         _I, _I, _I, _I, _I, _I, _I, _I,        # B, S, Nh, Hkv, D, Bk, M, window
         ctypes.c_float, _P]                    # scale, stream
    ),
    "paged_decode_fused": (
        [_P, _P, _P, _P, _P, _P, _P,            # q, new_k, new_v, kpool, vpool,
                                                # k_scale, v_scale
         _P, _P, _P, _P,                        # tables, pos, lens, out
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # B, Nh, Hkv, D, L, N, Bk, M,
                                                   # layer, window
         ctypes.c_float, _P, _P, _I, _I,        # scale, ws_o, ws_ml, pages/split, splits
         _P]                                    # stream
    ),
}
_fns: Dict[str, object] = {}


def _kernel(source: str, pool_dtype: torch.dtype):
    """The C entry of ``csrc/<source>.cu`` for one pool element type."""
    symbol = f"{source}_{_POOL_DTYPES[pool_dtype]}"
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.library(source), symbol)
        fn.argtypes = _SIGNATURES[source]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def kernel_takes(head_dim: int, activation_dtype: torch.dtype,
                 pool_dtype: torch.dtype) -> bool:
    """Do the attention kernels take this head_dim, activation dtype and
    KV pool dtype? ``TorchEngine`` refuses, on the card, a model they do
    not take; the wrappers raise on such operands."""
    return (head_dim in _HEAD_DIMS and activation_dtype == torch.bfloat16
            and pool_dtype in _POOL_DTYPES)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(name: str, device: torch.device, **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        _require(t.is_cuda and t.device == device,
                 f"{name}: {key} must be a CUDA tensor on {device}, got {t.device}")
        _require(t.is_contiguous(), f"{name}: {key} must be contiguous")


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {err}")


def _check_pools(name: str, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
                 scale_shape: Tuple[int, ...]) -> None:
    """Pool dtypes the kernels take, and scale pools exactly for int8."""
    _require(k_pool.dtype == v_pool.dtype and k_pool.dtype in _POOL_DTYPES,
             f"{name}: pools must be one of {sorted(map(str, _POOL_DTYPES))}, "
             f"got {k_pool.dtype}/{v_pool.dtype}")
    _require(v_pool.shape == k_pool.shape, f"{name}: k/v pool shapes differ")
    quantized = k_pool.dtype == torch.int8
    _require((k_scale is not None) == quantized and (v_scale is not None) == quantized,
             f"{name}: an int8 pool needs both k_scale and v_scale, other pools neither")
    if quantized:
        for key, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _require(t.dtype == torch.bfloat16 and tuple(t.shape) == scale_shape,
                     f"{name}: {key} must be bf16 {scale_shape}, got {t.dtype} "
                     f"{tuple(t.shape)}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# --------------------------------------------------------------------------
# Key-split plan
# --------------------------------------------------------------------------

# splits a row aims at, and the keys a split holds at least and at most: a
# 4096-key table gives 16 splits of 256 keys (the llama3-8b serving batch,
# 8 rows x 8 kv heads, makes 1024 blocks on 132 SMs), a 1024-key table 16
# of 64 keys, and wider tables splits of 256 keys. chip_smoke.py times 64
# to 512 keys a split at both widths through launch_decode_kernel (PERF.md
# keeps the numbers: at each width its size here was the fastest or within
# 4% of it)
SPLITS_PER_ROW = 16
SPLIT_KEYS_RANGE = (64, 256)


def kv_split_plan(max_blocks: int, block_size: int,
                  target_keys: Optional[int] = None) -> Tuple[int, int]:
    """(pages per split, number of splits) for block tables of width
    ``max_blocks`` and pages of ``block_size`` keys. Split s covers the
    whole pages [s * P, (s + 1) * P) of every row, i.e. keys [s * P * Bk,
    (s + 1) * P * Bk); the splits cover all ``max_blocks`` table entries.
    A split aims at the table's keys over SPLITS_PER_ROW, kept within
    SPLIT_KEYS_RANGE (``target_keys`` sets another aim, for measurements).
    A function of the two shapes alone: it reads no tensor, so a captured
    CUDA graph replays the same plan."""
    if target_keys is None:
        lo, hi = SPLIT_KEYS_RANGE
        target_keys = min(max(max_blocks * block_size // SPLITS_PER_ROW, lo), hi)
    if max_blocks < 1 or block_size < 1 or target_keys < 1:
        raise ValueError(f"kv_split_plan: table width {max_blocks}, block {block_size}, "
                         f"{target_keys} keys a split")
    pages = min(max_blocks, -(-target_keys // block_size))
    return pages, -(-max_blocks // pages)


# --------------------------------------------------------------------------
# Ragged paged attention
# --------------------------------------------------------------------------


def ragged_paged_attention(
    q: torch.Tensor,             # [B, S, Nh, D] — per-row spans padded to S
    k_pool: torch.Tensor,        # [N, Hkv, Bk, D] one layer's pool
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    positions: torch.Tensor,     # [B, S] int32 (-1 = pad)
    kv_lens: torch.Tensor,       # [B] int32 effective context per row
    block_size: int = 16,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # [N, Bk] bf16 (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ragged paged attention → [B, S, Nh, D] in q's dtype. Each row
    carries its own query span, block-table row and kv length; a query
    sees keys j < kv_len, j <= pos (and j > pos - window); queries with no
    visible key give exact zeros. Its plain version is
    ``ops.attention.paged_attention_ref``."""
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, k_pool, v_pool, block_tables, positions, kv_lens, block_size,
            window=window, k_scale=k_scale, v_scale=v_scale,
        )
    name = "ragged_paged_attention"
    scales = {key: t for key, t in (("k_scale", k_scale), ("v_scale", v_scale))
              if t is not None}
    _check_cuda(name, q.device, q=q, k_pool=k_pool, v_pool=v_pool,
                block_tables=block_tables, positions=positions, kv_lens=kv_lens,
                **scales)
    b, s, nh, d = q.shape
    n, hkv, bk, d2 = k_pool.shape
    m = block_tables.shape[1]
    _require(q.dtype == torch.bfloat16, f"{name}: the CUDA kernel takes bf16 q, got {q.dtype}")
    _check_pools(name, k_pool, v_pool, k_scale, v_scale, (n, bk))
    _require(d == d2 and d in _HEAD_DIMS,
             f"{name}: head_dim {d} (pool {d2}) not in {_HEAD_DIMS}")
    _require(bk == block_size, f"{name}: pool block dim {bk} != block_size {block_size}")
    _require(nh % hkv == 0 and nh // hkv <= 64,
             f"{name}: {nh} query heads over {hkv} kv heads")
    _require(block_tables.dim() == 2 and block_tables.shape[0] == b,
             f"{name}: block_tables {tuple(block_tables.shape)} for batch {b}")
    _require(tuple(positions.shape) == (b, s),
             f"{name}: positions {tuple(positions.shape)} != {(b, s)}")
    _require(tuple(kv_lens.shape) == (b,), f"{name}: kv_lens {tuple(kv_lens.shape)}")
    for key, t in (("block_tables", block_tables), ("positions", positions),
                   ("kv_lens", kv_lens)):
        _require(t.dtype == torch.int32, f"{name}: {key} must be int32, got {t.dtype}")
    out = torch.empty_like(q)
    err = _kernel(name, k_pool.dtype)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        block_tables.data_ptr(), positions.data_ptr(), kv_lens.data_ptr(),
        out.data_ptr(), b, s, nh, hkv, d, bk, m,
        int(window) if window is not None else 0, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error(name, err)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


# --------------------------------------------------------------------------
# Fused decode write + attention
# --------------------------------------------------------------------------


def paged_decode_attention_fused_plain(
    q: torch.Tensor, new_k: torch.Tensor, new_v: torch.Tensor,
    k_pool: torch.Tensor, v_pool: torch.Tensor, layer_idx: int,
    block_tables: torch.Tensor, positions: torch.Tensor,
    kv_lens: torch.Tensor, block_size: int = 16,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused kernel's plain version: the paged write (pad rows
    dropped; an int8 pool quantizes the rows per token and writes their
    scales, an fp8 pool casts), then the plain read over the updated
    layer."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8-KV pools need BOTH k_scale and v_scale (or neither)")
    ks = vs = None
    if k_scale is not None:
        ks, vs = k_scale[layer_idx], v_scale[layer_idx]
        write_quantized_kv(k_pool[layer_idx], ks, new_k, block_tables, positions, block_size)
        write_quantized_kv(v_pool[layer_idx], vs, new_v, block_tables, positions, block_size)
    else:
        write_kv_pages(k_pool[layer_idx], new_k, block_tables, positions, block_size)
        write_kv_pages(v_pool[layer_idx], new_v, block_tables, positions, block_size)
    attn = paged_attention_ref(
        q, k_pool[layer_idx], v_pool[layer_idx], block_tables, positions,
        kv_lens, block_size, window=window, k_scale=ks, v_scale=vs,
    )
    return attn, k_pool, v_pool


def paged_decode_attention_fused(
    q: torch.Tensor,             # [B, 1, Nh, D]
    new_k: torch.Tensor,         # [B, 1, Hkv, D] this step's K rows
    new_v: torch.Tensor,
    k_pool: torch.Tensor,        # [L, N, Hkv, Bk, D] stacked pools — IN PLACE
    v_pool: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [B, M] int32
    positions: torch.Tensor,     # [B, 1] int32 (-1 = inactive); also the
                                 # write position of the new row
    kv_lens: torch.Tensor,       # [B] int32, INCLUDING the written token
    block_size: int = 16,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # [L, N, Bk] bf16 (int8 pools) — IN PLACE
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's decode step: write this step's K/V rows into their page
    slots (an int8 pool quantizes them and writes their scales, an fp8
    pool casts) and attend over the updated context. → (attn [B, 1, Nh,
    D], k_pool, v_pool); the pools returned are the ones passed in,
    updated in place with the scale pools (the JAX package returned new,
    aliased arrays)."""
    if q.device.type == "cpu":
        return paged_decode_attention_fused_plain(
            q, new_k, new_v, k_pool, v_pool, layer_idx, block_tables,
            positions, kv_lens, block_size, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
    name = "paged_decode_attention_fused"
    scales = {key: t for key, t in (("k_scale", k_scale), ("v_scale", v_scale))
              if t is not None}
    _check_cuda(name, q.device, q=q, new_k=new_k, new_v=new_v, k_pool=k_pool,
                v_pool=v_pool, block_tables=block_tables, positions=positions,
                kv_lens=kv_lens, **scales)
    b, s, nh, d = q.shape
    nl, n, hkv, bk, d2 = k_pool.shape
    m = block_tables.shape[1]
    _require(s == 1, f"{name}: the decode kernel takes one query per row, got {s}")
    for key, t in (("q", q), ("new_k", new_k), ("new_v", new_v)):
        _require(t.dtype == torch.bfloat16,
                 f"{name}: the CUDA kernel takes bf16, {key} is {t.dtype}")
    _check_pools(name, k_pool, v_pool, k_scale, v_scale, (nl, n, bk))
    _require(tuple(new_k.shape) == (b, 1, hkv, d) == tuple(new_v.shape),
             f"{name}: new rows {tuple(new_k.shape)}/{tuple(new_v.shape)} "
             f"!= {(b, 1, hkv, d)}")
    _require(d == d2 and d in _HEAD_DIMS,
             f"{name}: head_dim {d} (pool {d2}) not in {_HEAD_DIMS}")
    _require(bk == block_size, f"{name}: pool block dim {bk} != block_size {block_size}")
    _require(nh % hkv == 0, f"{name}: {nh} query heads over {hkv} kv heads")
    _require(0 <= int(layer_idx) < nl, f"{name}: layer {layer_idx} outside [0, {nl})")
    _require(block_tables.dim() == 2 and block_tables.shape[0] == b,
             f"{name}: block_tables {tuple(block_tables.shape)} for batch {b}")
    _require(tuple(positions.shape) == (b, 1),
             f"{name}: positions {tuple(positions.shape)} != {(b, 1)}")
    _require(tuple(kv_lens.shape) == (b,), f"{name}: kv_lens {tuple(kv_lens.shape)}")
    for key, t in (("block_tables", block_tables), ("positions", positions),
                   ("kv_lens", kv_lens)):
        _require(t.dtype == torch.int32, f"{name}: {key} must be int32, got {t.dtype}")
    out = launch_decode_kernel(q, new_k, new_v, k_pool, v_pool, layer_idx, block_tables,
                               positions, kv_lens, window, k_scale, v_scale,
                               kv_split_plan(m, bk))
    return out, k_pool, v_pool


paged_decode_attention_fused.launches = 0


def launch_decode_kernel(q, new_k, new_v, k_pool, v_pool, layer_idx, block_tables, positions,
                         kv_lens, window, k_scale, v_scale,
                         plan: Tuple[int, int]) -> torch.Tensor:
    """Launch ``csrc/paged_decode_fused.cu`` on operands that
    :func:`paged_decode_attention_fused` has checked, with the split plan
    ``(pages per split, splits)`` (the wrapper passes :func:`kv_split_plan`;
    ``chip_smoke.py`` also times other plans). Counts one launch of
    ``paged_decode_attention_fused``. → attn [B, 1, Nh, D]."""
    b, _, nh, d = q.shape
    nl, n, hkv, bk, _ = k_pool.shape
    pages, splits = plan
    out = torch.empty_like(q)
    ws_o = torch.empty((b, nh, splits, d), dtype=torch.float32, device=q.device)
    ws_ml = torch.empty((b, nh, splits, 2), dtype=torch.float32, device=q.device)
    err = _kernel("paged_decode_fused", k_pool.dtype)(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        block_tables.data_ptr(),
        positions.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        b, nh, hkv, d, nl, n, bk, block_tables.shape[1], int(layer_idx),
        int(window) if window is not None else 0, d ** -0.5,
        ws_o.data_ptr(), ws_ml.data_ptr(), pages, splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error("paged_decode_attention_fused", err)
    paged_decode_attention_fused.launches += 1
    return out


KERNEL_WRAPPERS = (ragged_paged_attention, paged_decode_attention_fused, qmm_w8a16)


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel wrapper of the port (the quantized matmul
    of ``ops/qmm.py`` included) since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
