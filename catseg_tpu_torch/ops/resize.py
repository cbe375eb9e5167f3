"""Resizes on NHWC tensors; ``F.interpolate`` is the torch semantics that
catseg_tpu/ops/resize.py rebuilds as weight matrices, so it is their port.
The resize runs in fp32 and rounds back to the input dtype."""

from __future__ import annotations

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
