"""Normalization primitives with fp32 statistics (catseg_tpu/ops/norm.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.layer_norm import fused_layer_norm


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: the kernel on a CUDA tensor, its plain
    version on a CPU one."""
    return fused_layer_norm(x, scale, bias, eps)


def group_norm(x: torch.Tensor, num_groups: int, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """NHWC GroupNorm matching ``nn.GroupNorm(num_groups, C)``, fp32
    statistics.  Where autograd records it, the explicit composition
    catseg_tpu/ops/norm.py computes (fp32 mean, then the two-pass variance):
    each statistic is one reduction per (image, group), so its backward's
    order does not depend on torch's CPU thread count, as ``F.group_norm``'s
    CPU backward does.  Otherwise ``F.group_norm``, a few passes fewer."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        N, H, W, C = x.shape
        v = x.float().reshape(N, H * W, num_groups, C // num_groups)
        mean = v.mean((1, 3), keepdim=True)
        d = v - mean
        var = d.square().mean((1, 3), keepdim=True)
        y = (d * torch.rsqrt(var + eps)).reshape(N, H, W, C)
        return (y * scale.float() + bias.float()).to(x.dtype)
    y = F.group_norm(x.permute(0, 3, 1, 2).float(), num_groups, scale.float(), bias.float(), eps)
    return y.permute(0, 2, 3, 1).to(x.dtype)
