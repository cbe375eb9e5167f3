"""Swin window partition / reverse on NHWC tensors (catseg_tpu/ops/window.py)."""

from __future__ import annotations

import torch


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, window*window, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, C)


def window_reverse(windows: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    """(B * nH * nW, window*window, C) -> (B, H, W, C)."""
    nh, nw = H // window, W // window
    C = windows.shape[-1]
    x = windows.reshape(-1, nh, nw, window, window, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)
