"""Convolutions on NHWC activations with torch-layout weights.

Activations keep catseg_tpu's channels-last layout (catseg_tpu/ops/conv.py);
weights keep the layouts of the reference checkpoint's state dict (conv
OIHW, transposed conv (Cin, Cout, k, k)), so modules hold them exactly as
loaded.  The reference computes these outside any Pallas kernel, so
``F.conv*`` is their port.  A bias is added in fp32 and the result rounded
to the activation dtype, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _bias(out, b, dtype):
    if b is None:
        return out.to(dtype)
    return (out.float() + b.float()[:, None, None]).to(dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NHWC conv, OIHW weights, zero padding."""
    out = F.conv2d(_nchw(x), w.to(x.dtype), stride=stride, padding=padding)
    return _nhwc(_bias(out, b, x.dtype))


def conv_transpose2d_nonoverlap(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                                kernel: int = 2) -> torch.Tensor:
    """``nn.ConvTranspose2d(Cin, Cout, k, stride=k)`` on NHWC; w (Cin, Cout, k, k)."""
    if w.shape[2] != kernel or w.shape[3] != kernel:
        raise ValueError(f"weight {tuple(w.shape)} is not a {kernel}x{kernel} transposed conv")
    out = F.conv_transpose2d(_nchw(x), w.to(x.dtype), stride=kernel)
    return _nhwc(_bias(out, b, x.dtype))


def avg_pool2d(x: torch.Tensor, pool: tuple[int, int]) -> torch.Tensor:
    """NHWC AvgPool2d(kernel=stride=pool), fp32 mean, floor on ragged edges."""
    if tuple(pool) == (1, 1):
        return x
    return _nhwc(F.avg_pool2d(_nchw(x).float(), pool)).to(x.dtype)


def patchify(x: torch.Tensor, w: torch.Tensor, patch: int) -> torch.Tensor:
    """Bias-free patch-embedding conv (kernel = stride = patch) -> (B, grid^2, width)."""
    out = F.conv2d(_nchw(x), w.to(x.dtype), stride=patch)
    return out.flatten(2).transpose(1, 2)
