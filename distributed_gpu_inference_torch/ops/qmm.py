"""The weight-only quantized matmul: wrapper, plain version and launch
counter.

:func:`qmm_w8a16` computes ``x @ dequant(qw[layer])`` for bf16
activations and int8 / fp8 (e4m3) codes with a float32 per-output-channel
scale: f32 accumulation, the scale applied once to the finished sum, one
rounding to x's dtype. CUDA source: ``csrc/qmm_w8a16.cu``; replaces the
Pallas kernel ``_qmm_kernel`` (JAX package, ``ops/qmm_pallas.py``
``qmm_stacked_pallas``).

Dispatch by rows, on a CUDA tensor:

- ``M <= MAX_KERNEL_ROWS``: the hand-written kernel (every decode step's
  projections: M is the batch).
- above it: the codes are converted to x's dtype and ``torch.matmul``
  runs the product, with the scale applied to its result — the route the
  JAX package leaves to XLA for prefill (``quantization.matmul``). At
  those row counts the product is bound by operations, not by the bytes
  of the codes.

``MAX_KERNEL_ROWS`` is the H100's own bound, set from ``chip_smoke.py``'s
measurement of the kernel against that route at M in {8, ..., 256}
(PERF.md); the TPU package's 256 is not carried over. On a CPU tensor the
wrapper takes :func:`qmm_plain` whatever M is.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from distributed_gpu_inference_torch.ops import _build

# rows up to which the kernel serves a call: on an H100 (700 W) the kernel
# was at least as fast as the library route up to M = 128 for int8 codes
# and 256 for fp8 (chip_smoke.py phase 9, PERF.md)
MAX_KERNEL_ROWS = 128

_BN, _BK = 128, 64          # the kernel's column block and K stage
_TARGET_BLOCKS = 2 * 132    # about two blocks per SM of an H100
_CODE_DTYPES = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P,            # x, qw, scale, out, ws
             _I, _I, _I, _I, _I,            # M, K, N, L, layer
             _I, _I, _P]                    # splits, k_per_split, stream
_fns: Dict[str, object] = {}


def _kernel(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.library("qmm_w8a16"), symbol)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _as_stacked(qw: torch.Tensor, scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's ``[K, N]`` / ``[1, N]`` is a stack of one."""
    if qw.dim() == 2:
        qw, scale = qw[None], scale.reshape(1, 1, -1)
    return qw, scale.reshape(qw.shape[0], 1, qw.shape[2])


def qmm_plain(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
              layer: int = 0) -> torch.Tensor:
    """The kernel's plain version: ``(x @ qw[layer]) * scale[layer]`` in
    f32 (codes convert exactly), rounded once to x's dtype."""
    qw, scale = _as_stacked(qw, scale)
    acc = x.float() @ qw[layer].float()
    return (acc * scale[layer].float()).to(x.dtype)


def split_plan(m: int, k: int, n: int) -> Tuple[int, int]:
    """(splits, K rows per split): enough K splits that the column blocks
    times the row groups times the splits reach about two blocks per SM,
    each split a whole number of 64-row stages."""
    rows = 16 if m <= 16 else 32 if m <= 32 else 64
    blocks = -(-n // _BN) * -(-m // rows)
    stages = -(-k // _BK)
    splits = max(1, min(-(-_TARGET_BLOCKS // blocks), stages))
    per = -(-stages // splits) * _BK
    return -(-k // per), per


def _library_route(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Above the row bound: codes converted to x's dtype, ``torch.matmul``,
    the scale applied to its result (the JAX package's XLA route)."""
    out = torch.matmul(x, qw.to(x.dtype))
    return (out.float() * scale.float()).to(x.dtype)


def qmm_w8a16(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
              layer: int = 0) -> torch.Tensor:
    """``x [M, K] @ dequant(qw[layer])`` → ``[M, N]`` in x's dtype.
    ``qw`` is ``[L, K, N]`` codes (or one layer's ``[K, N]``), ``scale``
    ``[L, 1, N]`` f32 (or ``[1, N]``). On a CUDA tensor, M up to
    :data:`MAX_KERNEL_ROWS` launches the kernel and larger M take the
    library route; on a CPU tensor, :func:`qmm_plain`."""
    if x.device.type == "cpu":
        return qmm_plain(x, qw, scale, layer)
    qw, scale = _as_stacked(qw, scale)
    _check("qmm_w8a16", x, qw, scale, layer)
    if x.shape[0] > MAX_KERNEL_ROWS:
        return _library_route(x, qw[layer], scale[layer])
    return _launch(x, qw, scale, layer)


qmm_w8a16.launches = 0


def _check(name: str, x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
           layer: int) -> None:
    m, k = x.shape
    nl, k2, n = qw.shape
    for key, t in (("x", x), ("qw", qw), ("scale", scale)):
        if not (t.is_cuda and t.device == x.device):
            raise ValueError(f"{name}: {key} must be a CUDA tensor on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel takes bf16 activations, got {x.dtype}")
    if qw.dtype not in _CODE_DTYPES:
        raise ValueError(f"{name}: codes must be int8 or float8_e4m3fn, got {qw.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"{name}: scale must be float32, got {scale.dtype}")
    if k != k2 or k % 16 or n % 16:
        raise ValueError(f"{name}: x [{m}, {k}] @ codes [{k2}, {n}]: K and N must "
                         "agree and be multiples of 16")
    if not 0 <= int(layer) < nl:
        raise ValueError(f"{name}: layer {layer} outside [0, {nl})")


def launch_kernel(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                  layer: int = 0) -> torch.Tensor:
    """Launch ``csrc/qmm_w8a16.cu`` on stacked CUDA operands whatever M is
    (``qmm_w8a16`` calls it up to the row bound; ``chip_smoke.py`` also
    times it above the bound to measure where the bound lies). Counts one
    launch of ``qmm_w8a16``."""
    qw, scale = _as_stacked(qw, scale)
    _check("qmm_w8a16", x, qw, scale, layer)
    return _launch(x, qw, scale, layer)


def _launch(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
            layer: int) -> torch.Tensor:
    m, k = x.shape
    nl, _, n = qw.shape
    splits, per = split_plan(m, k, n)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    err = _kernel(f"qmm_w8a16_{_CODE_DTYPES[qw.dtype]}")(
        x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, k, n, nl, int(layer), splits, per,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"qmm_w8a16: CUDA kernel launch failed with error {err}")
    qmm_w8a16.launches += 1
    return out
