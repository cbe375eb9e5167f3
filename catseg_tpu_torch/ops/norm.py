"""Normalization primitives with fp32 statistics (catseg_tpu/ops/norm.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.layer_norm import fused_layer_norm


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; the fused kernel where the reference's
    gate holds (C % 128 == 0, >= 512 rows), its plain version elsewhere."""
    return fused_layer_norm(x, scale, bias, eps)


def group_norm(x: torch.Tensor, num_groups: int, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """NHWC GroupNorm matching ``nn.GroupNorm(num_groups, C)``, fp32 statistics."""
    y = F.group_norm(x.permute(0, 3, 1, 2).float(), num_groups, scale.float(), bias.float(), eps)
    return y.permute(0, 2, 3, 1).to(x.dtype)
