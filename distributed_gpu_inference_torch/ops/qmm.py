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
  projections: M is the batch). One launch a call: K is split across
  blocks by :func:`split_plan`, and the split that finishes a tile last
  sums the tile's partials in split order. The partials and the per-tile
  arrival counters live in scratch that this module keeps per device and
  grows only outside CUDA-graph capture (:func:`_scratch`). Every caller
  of a device shares it, from any thread and on any stream: launches on
  one stream run in order, and a launch on another stream than the last
  one to use the scratch first waits for that stream's work
  (:func:`_claim`).
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
import functools
import threading
from typing import Dict, List, Optional, Tuple

import torch

from distributed_gpu_inference_torch.ops import _build

# rows up to which the kernel serves a call: on an H100 (700 W) the kernel
# was at least as fast as the library route up to M = 128 for int8 codes
# and 256 for fp8 (chip_smoke.py phase 9, PERF.md; measured again after
# the ring redesign, unchanged)
MAX_KERNEL_ROWS = 128

# the kernel's compile-time geometry (csrc/qmm_w8a16.cu QMM_STAGES, QMM_BK
# and its fixed 128-column block): ring stages, K rows a stage, output
# columns a block; chosen by chip_smoke.py phase 9's sweep (PERF.md)
STAGES, STAGE_ROWS, BLOCK_COLS = 3, 64, 128
Geometry = Tuple[int, int, int]
GEOMETRY: Geometry = (STAGES, STAGE_ROWS, BLOCK_COLS)
TARGET_BLOCKS = 2 * 132     # about two blocks on each SM of an H100
_CODE_DTYPES = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P,            # x, qw, scale, out, ws
             _I, _I, _I, _I, _I,            # M, K, N, L, layer
             _I, _I, _P, _P]                # splits, k_per_split, counters, stream
_fns: Dict[Tuple[str, _build.Defines], Tuple[object, Geometry]] = {}


def _kernel(mode: str, variant: _build.Defines = ()):
    """(C entry, geometry) of the default build or of ``variant``."""
    hit = _fns.get((mode, variant))
    if hit is None:
        lib = _build.library("qmm_w8a16", variant)
        geometry = library_geometry(lib)
        if not variant and geometry != GEOMETRY:
            raise RuntimeError(f"qmm_w8a16: the library was built for geometry {geometry}, "
                               f"the wrapper plans for {GEOMETRY}")
        fn = getattr(lib, f"qmm_w8a16_{mode}")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        hit = _fns[(mode, variant)] = (fn, geometry)
    return hit


def library_geometry(lib: ctypes.CDLL) -> Geometry:
    """(stages, stage rows, block columns) a loaded build was compiled for."""
    vals = [ctypes.c_int() for _ in range(3)]
    lib.qmm_w8a16_geometry(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


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


def row_group(m: int) -> int:
    """Rows one block of the kernel owns: 16, 32 or 64."""
    return 16 if m <= 16 else 32 if m <= 32 else 64


def split_plan(m: int, k: int, n: int, geometry: Geometry = GEOMETRY) -> Tuple[int, int]:
    """(splits, K rows per split) for the kernel at ``geometry``: enough K
    splits that the tiles (column blocks x row groups) times the splits
    reach :data:`TARGET_BLOCKS`, but no split shorter than the ring (``stages``
    whole stages) wherever K has that many, the last one included, so
    every split can fill its ring. A pure function of the shape: the same
    plan on every call, so a captured CUDA graph stays valid."""
    stages, rows, cols = geometry
    tiles = max(1, -(-n // cols) * -(-m // row_group(m)))
    total = -(-k // rows)
    splits = max(1, min(-(-TARGET_BLOCKS // tiles), total // stages))
    while True:
        per = -(-total // splits)
        used = -(-total // per)
        if used == 1 or total - (used - 1) * per >= stages:
            return used, per * rows
        splits -= 1


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
    _check("qmm_w8a16", x, qw, scale, layer)
    if x.shape[0] > MAX_KERNEL_ROWS:
        qw, scale = _as_stacked(qw, scale)
        return _library_route(x, qw[layer], scale[layer])
    return _launch(x, qw, scale, layer)


qmm_w8a16.launches = 0


def _check(name: str, x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
           layer: int) -> None:
    """Refuse what the kernel does not take (it runs on every projection
    of a decode step, so the common case is tested first, in few steps)."""
    dev = x.device
    if not (x.is_cuda and qw.device == dev and scale.device == dev and x.is_contiguous()
            and qw.is_contiguous() and scale.is_contiguous()):
        for key, t in (("x", x), ("qw", qw), ("scale", scale)):
            if not (t.is_cuda and t.device == dev):
                raise ValueError(f"{name}: {key} must be a CUDA tensor on {dev}, got {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {key} must be contiguous")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel takes bf16 activations, got {x.dtype}")
    if qw.dtype not in _CODE_DTYPES:
        raise ValueError(f"{name}: codes must be int8 or float8_e4m3fn, got {qw.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"{name}: scale must be float32, got {scale.dtype}")
    m, k = x.shape
    k2, n = qw.shape[-2:]
    nl = qw.shape[0] if qw.dim() == 3 else 1
    if qw.dim() not in (2, 3) or scale.numel() != nl * n:
        raise ValueError(f"{name}: codes must be [L, K, N] or [K, N] with an f32 scale of "
                         f"L * N values, got {tuple(qw.shape)} and {tuple(scale.shape)}")
    if k != k2 or k % 16 or n % 16:
        raise ValueError(f"{name}: x [{m}, {k}] @ codes [{k2}, {n}]: K and N must "
                         "agree and be multiples of 16")
    if x.data_ptr() % 16 or qw.data_ptr() % 16:
        raise ValueError(f"{name}: x and qw must start on a 16-byte boundary")
    if not 0 <= layer < nl:
        raise ValueError(f"{name}: layer {layer} outside [0, {nl})")


def launch_kernel(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                  layer: int = 0, variant: _build.Defines = ()) -> torch.Tensor:
    """Launch ``csrc/qmm_w8a16.cu`` on CUDA operands whatever M is
    (``qmm_w8a16`` calls it up to the row bound; ``chip_smoke.py`` also
    times it above the bound to measure where the bound lies). ``variant``
    picks a build with other compile-time geometry (``(("QMM_STAGES", 6),)``),
    planned for that geometry, for measurements. Counts one launch of
    ``qmm_w8a16``."""
    _check("qmm_w8a16", x, qw, scale, layer)
    return _launch(x, qw, scale, layer, variant)


class _Scratch:
    """One device's f32 partials and zeroed int32 arrival counters. Grown
    (never shrunk) outside capture; a buffer it outgrows stays alive,
    since a captured CUDA graph may still address it. ``lock`` is held
    from the size check to the launch; ``stream`` is the raw handle of the
    stream that last launched on it (``stream_obj`` its ``torch.cuda.Stream``)."""

    def __init__(self) -> None:
        self.ws: Optional[torch.Tensor] = None
        self.counters: Optional[torch.Tensor] = None
        self.retired: List[torch.Tensor] = []
        self.lock = threading.Lock()
        self.stream: Optional[int] = None
        self.stream_obj: Optional[torch.cuda.Stream] = None


_scratch_by_device: Dict[int, _Scratch] = {}


def _scratch(device: torch.device, ws_elems: int, n_counters: int) -> _Scratch:
    """The device's scratch, grown to ``ws_elems`` partials and
    ``n_counters`` counters; the caller holds its ``lock``."""
    s = _scratch_by_device[device.index]
    small_ws = s.ws is None or s.ws.numel() < ws_elems
    small_ctr = s.counters is None or s.counters.numel() < n_counters
    if small_ws or small_ctr:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "qmm_w8a16: its scratch must grow, which it cannot do during CUDA-graph "
                "capture; call it once at this shape before capturing")
        if small_ws:
            if s.ws is not None:
                s.retired.append(s.ws)
            s.ws = torch.empty(max(ws_elems, 2 * (0 if s.ws is None else s.ws.numel())),
                               dtype=torch.float32, device=device)
        if small_ctr:
            if s.counters is not None:
                s.retired.append(s.counters)
            s.counters = torch.zeros(
                max(n_counters, 2 * (0 if s.counters is None else s.counters.numel())),
                dtype=torch.int32, device=device)
    return s


def _claim(s: _Scratch, device: torch.device, stream: int) -> None:
    """Order this launch after the scratch's last user: two launches on one
    stream run one after the other, but on two streams they could run at
    once and mix their partials and counters. Under capture the wait is
    left out: ``torch.cuda.graph`` synchronises the device before it
    captures, so the earlier users are done."""
    cur = torch.cuda.current_stream(device)
    if s.stream_obj is not None and not torch.cuda.is_current_stream_capturing():
        done = torch.cuda.Event()
        done.record(s.stream_obj)
        cur.wait_event(done)
    s.stream, s.stream_obj = stream, cur


_plans = functools.lru_cache(maxsize=4096)(split_plan)


def _launch(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, layer: int,
            variant: _build.Defines = ()) -> torch.Tensor:
    m, k = x.shape
    n = qw.shape[-1]
    nl = qw.shape[0] if qw.dim() == 3 else 1
    fn, geometry = _kernel(_CODE_DTYPES[qw.dtype], variant)
    splits, per = _plans(m, k, n, geometry)
    dev = x.device
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    # the raw handle of the current stream: torch.cuda.current_stream() builds a
    # Stream object, several microseconds of host time on every projection
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr())
    if splits == 1:
        err = fn(*args, None, m, k, n, nl, layer, splits, per, None, stream)
    else:
        s = _scratch_by_device.get(dev.index) or \
            _scratch_by_device.setdefault(dev.index, _Scratch())   # atomic
        with s.lock:
            _scratch(dev, splits * m * n, -(-n // geometry[2]) * -(-m // row_group(m)))
            if s.stream != stream:
                _claim(s, dev, stream)
            err = fn(*args, s.ws.data_ptr(), m, k, n, nl, layer, splits, per,
                     s.counters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"qmm_w8a16: CUDA kernel launch failed with error {err}")
    qmm_w8a16.launches += 1
    return out
