"""Pillow's bicubic resize without Pillow.

``resize_bicubic(img, (w, h))`` equals Pillow 12.1.0's
``Image.fromarray(img).resize((w, h))`` bit for bit on an ``[H, W, 3]``
uint8 image: the default filter BICUBIC (a = -0.5) through
``libImaging/Resample.c``. The filter's support is scaled by the ratio
when reducing; each output sample's coefficients are normalised to sum to
one, then put in fixed point with ``PRECISION_BITS`` = 22; the horizontal
pass runs first, over only the input rows the vertical pass reads; each
pass rounds and clips to uint8. A size equal to the input's is a copy, and
a pass whose dimension keeps its size is skipped, as in Pillow.

:func:`resize_bicubic` runs the C++ version (``native/src/image_codec.cpp``);
:func:`resize_bicubic_plain` is its plain version in numpy, taken with a
logged warning where the library cannot be built.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np

from ..native import host_lib

PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0      # BICUBIC's

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _check(img: np.ndarray, size: Tuple[int, int]) -> Tuple[np.ndarray, int, int]:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resize takes [H, W, 3] uint8, got {img.dtype} {img.shape}")
    ow, oh = (int(s) for s in size)
    if ow < 1 or oh < 1:
        raise ValueError(f"resize to {size}: both sides must be at least 1")
    return img, ow, oh


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``[H, W, 3]`` uint8 → ``[h, w, 3]`` uint8 for ``size = (w, h)``,
    as Pillow's ``Image.resize(size)`` (see the module docstring)."""
    img, ow, oh = _check(img, size)
    lib = host_lib("resize_bicubic", "resize_bicubic_plain")
    if lib is None:
        return resize_bicubic_plain(img, size)
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.resize_bicubic_rgb(img.ctypes.data_as(_U8P), img.shape[0], img.shape[1],
                                out.ctypes.data_as(_U8P), oh, ow)
    if rc:
        raise MemoryError(f"resize of {img.shape} to {size} failed ({rc})")
    return out


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: per
    output sample, the first input index, the count of inputs, and the
    [out, ksize] int fixed-point weights (zero past the count)."""
    filterscale = scale = float(np.float32(in_size)) / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xx = np.arange(out_size, dtype=np.float64)
    center = 0.0 + (xx + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    valid = x[None, :] < xmax[:, None]
    w = np.where(valid, _bicubic(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss),
                 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):      # C's summation order
        ww = ww + w[:, i]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * (1 << PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, xmax, k


def _pass(img: np.ndarray, axis: int, xmin: np.ndarray, k: np.ndarray) -> np.ndarray:
    """One pass along ``axis`` (0 rows, 1 columns): int accumulate from
    the half, shift by PRECISION_BITS, clip to uint8."""
    n_in = img.shape[axis]
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], n_in - 1)
    src = np.moveaxis(img.astype(np.int64), axis, 0)            # [n_in, other, 3]
    acc = np.full((len(xmin),) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        acc += src[idx[:, j]] * k[:, j][:, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic_plain(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """The plain version of :func:`resize_bicubic`, in numpy."""
    img, ow, oh = _check(img, size)
    h, w = img.shape[:2]
    if (ow, oh) == (w, h):
        return img.copy()
    hx0, _, hk = _coeffs(w, ow)
    vy0, vn, vk = _coeffs(h, oh)
    if ow != w:
        first, last = int(vy0[0]), int(vy0[-1] + vn[-1])
        img = _pass(img[first:last], 1, hx0, hk)
        vy0 = vy0 - first
    if oh != h:
        img = _pass(img, 0, vy0, vk)
    return img
