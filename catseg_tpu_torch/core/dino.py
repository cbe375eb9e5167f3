"""DINO ViT image encoder (catseg_tpu/core/dino.py), the Ver31 fusion
family's second encoder, as an nn.Module.

facebookresearch/dino's ViT (the fork's cat_seg/vision_transformer.py):
pre-norm blocks with a fused qkv, a CLS token, the positional embedding
resized bicubically with DINO's +0.1 scale-factor fudge, and
:func:`get_intermediate_layers`, which applies the *final* norm to every
returned block.  Attribute names are the checkpoint's (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,
mlp.fc1,mlp.fc2}``, ``norm``), as ``weights.export.export_dino_state_dict``
emits them.

Numerics follow the reference: matmuls in the compute dtype with fp32
accumulation and an fp32 bias; the LayerNorms through ``ops.layer_norm``
(the LayerNorm kernel on the card); attention the reference's plain
composition (q scaled in the compute dtype, fp32 logits, fp32 softmax, the
probabilities rounded to the compute dtype, an fp32 value product); exact
(erf) GELU whatever the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv2d, cubic_weights, layer_norm, plain_attention
from .aggregator import Conv
from .clip import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class DINOVariant:
    patch: int = 8
    width: int = 768
    layers: int = 12
    heads: int = 12
    pretrain_grid: int = 28  # 224 / 8


DINO_VITB8 = DINOVariant()

DINO_VARIANTS: dict[str, DINOVariant] = {"dino_vitb8": DINO_VITB8}


class Block(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.norm1 = LayerNorm(width)
        self.attn = nn.ModuleDict(dict(qkv=Linear(width, 3 * width), proj=Linear(width, width)))
        self.norm2 = LayerNorm(width)
        self.mlp = nn.ModuleDict(dict(fc1=Linear(width, 4 * width), fc2=Linear(4 * width, width)))

    def forward(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        B, N, C = x.shape
        D = C // heads
        qkv = self.attn.qkv(self.norm1(x)).reshape(B, N, 3, heads, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))    # (B, heads, N, D)
        out = plain_attention(q * (D ** -0.5), k, v)
        x = x + self.attn.proj(out.transpose(1, 2).reshape(B, N, C))
        y = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x + y


class DINO(nn.Module):
    def __init__(self, variant: DINOVariant = DINO_VITB8):
        super().__init__()
        self.variant = variant
        w = variant.width
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(3, w, variant.patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, w))
        self.pos_embed = nn.Parameter(torch.empty(1, variant.pretrain_grid ** 2 + 1, w))
        self.blocks = nn.ModuleList(Block(w) for _ in range(variant.layers))
        self.norm = LayerNorm(w)


def interpolate_pos_embed(pe: torch.Tensor, pretrain_grid: int, grid: int) -> torch.Tensor:
    """(1 + N^2, D) -> (1 + grid^2, D): DINO's bicubic resize with the scale
    factor (grid + 0.1) / N (vision_transformer.py:214-234), in fp32."""
    if grid == pretrain_grid:
        return pe
    D = pe.shape[-1]
    scale = (grid + 0.1) / pretrain_grid
    out = int(math.floor(pretrain_grid * scale))
    if out != grid:
        raise ValueError(f"DINO's scale-factor resize of a {pretrain_grid} grid gives {out}, not {grid}")
    wmat = torch.tensor(cubic_weights(pretrain_grid, grid, scale), dtype=torch.float32, device=pe.device)
    g = pe[1:].reshape(pretrain_grid, pretrain_grid, D).float()
    g = torch.einsum("hwd,Hh->Hwd", g, wmat)
    g = torch.einsum("Hwd,Ww->HWd", g, wmat)
    return torch.cat([pe[:1].float(), g.reshape(grid * grid, D)]).to(pe.dtype)


def get_intermediate_layers(dino: DINO, images: torch.Tensor, n: int | None = None,
                            compute_dtype=torch.float32) -> list[torch.Tensor]:
    """Token states, the final norm applied, of the last ``n`` blocks (all by
    default): images (B, H, W, 3) normalized -> list of (B, 1 + G^2, width)."""
    v = dino.variant
    n = v.layers if n is None else n
    B, H = images.shape[:2]
    grid = H // v.patch
    x = conv2d(images.to(compute_dtype), dino.patch_embed.proj.weight, dino.patch_embed.proj.bias,
               stride=v.patch).reshape(B, grid * grid, v.width)
    x = torch.cat([dino.cls_token.to(x.dtype).expand(B, 1, v.width), x], dim=1)
    x = x + interpolate_pos_embed(dino.pos_embed[0], v.pretrain_grid, grid).to(x.dtype)
    outs = []
    for i, blk in enumerate(dino.blocks):
        x = blk(x, v.heads)
        if i >= v.layers - n:
            outs.append(layer_norm(x, dino.norm.weight, dino.norm.bias))
    return outs


@torch.no_grad()
def init_dino_(dino: DINO, gen: torch.Generator) -> DINO:
    """Seeded init with catseg_tpu's init_dino_params scales: weights,
    CLS token and positional embedding N(0, 0.02), biases 0, norms 1 / 0."""
    def normal_(p):
        p.copy_(torch.randn(p.shape, generator=gen) * 0.02)

    for name, p in dino.named_parameters():
        if name.endswith("bias") or name.startswith("norm") or ".norm" in name:
            p.copy_(torch.ones_like(p) if name.endswith("weight") else torch.zeros_like(p))
        else:
            normal_(p)
    return dino
