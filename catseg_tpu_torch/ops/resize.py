"""Resizes on NHWC tensors; ``F.interpolate`` is the torch semantics that
catseg_tpu/ops/resize.py rebuilds as weight matrices, so it is their port.
The resize runs in fp32 and rounds back to the input dtype.

The float64 resize matrices (:func:`cubic_weights`, :func:`linear_weights`)
are the reference's arithmetic where it resizes parameters (positional
embeddings, relative-position tables) by explicit weights, not by
``F.interpolate``: float32 source coordinates, float64 taps."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _resize(x, out_hw, mode, align_corners):
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(out_hw), mode=mode,
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    return _resize(x, out_hw, "bilinear", align_corners)


def resize_bicubic(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """Keys cubic with a = -0.75, edge-clamped taps (torch's bicubic)."""
    return _resize(x, out_hw, "bicubic", align_corners)


def cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch's cubic convolution kernel (Keys, a = -0.75)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax <= 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def cubic_weights(in_size: int, out_size: int, scale: float | None = None) -> np.ndarray:
    """(out_size, in_size) float64 bicubic matrix, align_corners=False: four
    Keys taps at the float32 source coordinate (i + 0.5) * in / out - 0.5,
    or (i + 0.5) / scale - 0.5 for an interpolate given an explicit
    ``scale`` factor, indices clamped to the edge."""
    i = np.arange(out_size, dtype=np.float32)
    if scale is None:
        x = (i + np.float32(0.5)) * (np.float32(in_size) / np.float32(out_size)) - np.float32(0.5)
    else:
        x = (i + np.float32(0.5)) / np.float32(scale) - np.float32(0.5)
    x0 = np.floor(x).astype(np.int64)
    f = (x - x0.astype(np.float32)).astype(np.float64)
    w = np.zeros((out_size, in_size))
    rows = np.arange(out_size)
    for t in range(-1, 3):
        np.add.at(w, (rows, np.clip(x0 + t, 0, in_size - 1)), cubic_kernel(f - t))
    return w


def linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float64 torch-bilinear (align_corners=False)
    matrix: float32 source coordinates clamped at 0, edge taps merged."""
    if in_size == out_size:
        return np.eye(out_size)
    i = np.arange(out_size, dtype=np.float32)
    x = np.clip((i + np.float32(0.5)) * (np.float32(in_size) / np.float32(out_size)) - np.float32(0.5),
                np.float32(0.0), None)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    f = (x - x0.astype(np.float32)).astype(np.float64)
    w = np.zeros((out_size, in_size))
    np.add.at(w, (np.arange(out_size), x0), 1.0 - f)
    np.add.at(w, (np.arange(out_size), x1), f)
    return w
