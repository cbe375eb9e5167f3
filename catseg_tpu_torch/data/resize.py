"""uint8 image and label-map resizes that give the reference library's bytes.

``F.interpolate`` (even with ``antialias=True``) is not this function: the
JAX package resizes through ``Image.resize``, and the port's inputs must be
its inputs.  All three follow Pillow's ``Resample.c`` arithmetic.

BILINEAR (:func:`resize_bilinear_u8`, run by ``csrc/host/resize.cpp``; the
numpy :func:`resize_bilinear_u8_numpy` is its specification, and the tests
hold the two equal): a triangle filter whose support is
``max(in / out, 1)``; output i's window is ``center = (i + 0.5) * in / out``,
``xmin = int(center - support + 0.5)`` clamped to 0, ``xmax = int(center +
support + 0.5)`` clamped to ``in``; weights normalised by their (sequential,
double) sum and each made ``int(+-0.5 + w * 2**22)``; sums start at
``2**21``, are shifted right by 22 and clipped to uint8.  The horizontal pass
runs first, clipped to uint8, then the vertical; an axis whose size does not
change is not resampled.

NEAREST (:func:`resize_nearest`, the GT as a 32-bit map): source index
``int()`` of a running double sum that starts at ``a / 2`` and adds ``a =
in / out`` each step (Pillow's ``ImagingScaleAffine``); the closed form
``floor((i + 0.5) * a)`` differs from it on a fifth of the pixels at
512 -> 384.
"""

from __future__ import annotations

import numpy as np

from .image_io import host_library

PRECISION_BITS = 22


def _triangle(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _cubic(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` (a = -0.5), its operations in its order."""
    a = -0.5
    x = np.abs(x)
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    outer = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


# filter name -> (function, support at scale 1)
_FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_cubic, 2.0)}


def _coeffs(in_size: int, out_size: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """(out, k) source indices and int64 fixed-point weights (0 past a window)."""
    fn, base = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    x = np.arange(ksize)
    w = fn(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):        # the reference sums in order; np.sum would pair
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << PRECISION_BITS)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + x[None, :], in_size - 1)
    return idx, fixed


def _pass(img: np.ndarray, axis: int, out_size: int, kind: str) -> np.ndarray:
    idx, w = _coeffs(img.shape[axis], out_size, kind)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:], 1 << (PRECISION_BITS - 1), np.int64)
    for k in range(idx.shape[1]):
        acc += np.take(img, idx[:, k], axis=axis).astype(np.int64) * w[:, k].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_host(fn_name: str, img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W = img.shape[:2]
    C = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((hw[0], hw[1]) + img.shape[2:], np.uint8)
    getattr(host_library(), fn_name)(img.ctypes.data, H, W, C, out.ctypes.data, hw[0], hw[1])
    return out


def _resize_numpy(img: np.ndarray, hw: tuple[int, int], kind: str) -> np.ndarray:
    h, w = hw
    out = img
    if w != img.shape[1]:
        out = _pass(out, 1, w, kind)
    if h != img.shape[0]:
        out = _pass(out, 0, h, kind)
    return out


def resize_bilinear_u8(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) uint8 -> (h, w[, C]) uint8, ``Image.resize(BILINEAR)``, in
    the host library (it releases the GIL)."""
    return _resize_host("catseg_resize_bilinear_u8", img, hw)


def resize_bilinear_u8_numpy(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """The numpy specification of :func:`resize_bilinear_u8`."""
    return _resize_numpy(img, hw, "bilinear")


def resize_bicubic_u8(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) uint8 -> (h, w[, C]) uint8, ``Image.resize(BICUBIC)`` (the
    reference library's default filter), in the host library."""
    return _resize_host("catseg_resize_bicubic_u8", img, hw)


def resize_bicubic_u8_numpy(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """The numpy specification of :func:`resize_bicubic_u8`."""
    return _resize_numpy(img, hw, "bicubic")


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    a = in_size / out_size
    steps = np.full(out_size, a)
    steps[0] = a * 0.5
    return np.add.accumulate(steps).astype(np.int64)   # sequential running sum, truncated


def resize_nearest(arr: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(H, W) map -> (h, w), ``Image.resize(NEAREST)`` of a mode-"I" image."""
    return arr[_nearest_index(arr.shape[0], hw[0])[:, None], _nearest_index(arr.shape[1], hw[1])[None, :]]
