"""SAM (Segment Anything) ViT image encoder (catseg_tpu/core/sam.py), the
Ver14 fusion family's second encoder, as an nn.Module.

Meta SAM's ImageEncoderViT: a patch-embed conv, an additive positional
embedding on the (H, W) token grid, blocks that attend inside windows
(zero-padded to a multiple of the window) except at the global-attention
indexes, decomposed relative-position biases, and a conv -> LayerNorm2d ->
conv -> LayerNorm2d neck to 256 channels.  Attribute names are the
checkpoint's (``patch_embed.proj``, ``pos_embed``, ``blocks.{i}.{norm1,
attn.qkv,attn.proj,attn.rel_pos_h,attn.rel_pos_w,norm2,mlp.lin1,mlp.lin2}``,
``neck.{0,1,2,3}``), as ``weights.export.export_sam_state_dict`` emits them.

Numerics follow the reference: matmuls in the compute dtype with fp32
accumulation; block LayerNorms through ``ops.layer_norm`` (the LayerNorm
kernel on the card); attention the reference's plain composition with the
rel-pos terms added to the fp32 logits; LayerNorm2d (eps 1e-6) plain fp32;
exact GELU.  The encoder runs image by image: a global block over a 64 x 64
grid holds 12 x 4096^2 fp32 logits (0.8 GB) per image.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv2d, linear_weights, plain_attention, resize_bicubic
from .aggregator import Conv
from .clip import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class SAMVariant:
    img_size: int = 1024
    patch: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    out_chans: int = 256
    window: int = 14
    global_blocks: tuple[int, ...] = (2, 5, 8, 11)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch


SAM_VITB = SAMVariant()
SAM_VITL = SAMVariant(width=1024, layers=24, heads=16, global_blocks=(5, 11, 17, 23))
SAM_VITH = SAMVariant(width=1280, layers=32, heads=16, global_blocks=(7, 15, 23, 31))

SAM_VARIANTS = {"sam_vitb": SAM_VITB, "sam_vitl": SAM_VITL, "sam_vith": SAM_VITH}


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(L, D) table -> (q_size, k_size, D) biases (image_encoder.py:304-334);
    a table trained at another size is resized linearly first."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        w = torch.tensor(linear_weights(rel_pos.shape[0], max_rel), dtype=torch.float32, device=rel_pos.device)
        rel_pos = torch.einsum("lc,ml->mc", rel_pos.float(), w).to(rel_pos.dtype)
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[torch.from_numpy(rel.astype(np.int64)).to(rel_pos.device)]


class Attention(nn.Module):
    def __init__(self, width: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(width, 3 * width)
        self.proj = Linear(width, width)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, width // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, width // heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) token grids -> (B, H, W, C), decomposed rel-pos biases."""
        B, H, W, C = x.shape
        heads = self.heads
        D = C // heads
        qkv = self.qkv(x.reshape(B, H * W, C)).reshape(B, H * W, 3, heads, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))      # (B, heads, HW, D)
        Rh = get_rel_pos(H, H, self.rel_pos_h).float()
        Rw = get_rel_pos(W, W, self.rel_pos_w).float()
        rq = q.transpose(1, 2).reshape(B, H, W, heads, D).float()
        rel_h = torch.einsum("bhwnd,hkd->bnhwk", rq, Rh)
        rel_w = torch.einsum("bhwnd,wkd->bnhwk", rq, Rw)

        def add_rel(logits):
            logits = logits.view(B, heads, H, W, H, W)
            logits += rel_h[..., :, None]
            logits += rel_w[..., None, :]
            return logits.view(B, heads, H * W, H * W)

        out = plain_attention(q * (D ** -0.5), k, v, add_rel)
        return self.proj(out.transpose(1, 2).reshape(B, H * W, C)).reshape(B, H, W, C)


class Block(nn.Module):
    def __init__(self, width: int, heads: int, window: int, size: int):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(width)
        self.attn = Attention(width, heads, size)
        self.norm2 = LayerNorm(width)
        self.mlp = nn.ModuleDict(dict(lin1=Linear(width, 4 * width), lin2=Linear(4 * width, width)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window > 0:
            H, W = x.shape[1:3]
            x, pad_hw = window_partition_pad(x, self.window)
            x = window_unpartition(self.attn(x), self.window, pad_hw, (H, W))
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp.lin2(F.gelu(self.mlp.lin1(self.norm2(x))))


def window_partition_pad(x: torch.Tensor, window: int):
    """(B, H, W, C) -> (B * nW, window, window, C) windows of the grid
    zero-padded at the bottom and right to multiples of ``window``."""
    B, H, W, C = x.shape
    ph, pw = -H % window, -W % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(wins: torch.Tensor, window: int, pad_hw, hw) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    C = wins.shape[-1]
    B = wins.shape[0] // ((Hp // window) * (Wp // window))
    x = wins.reshape(B, Hp // window, Wp // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)[:, :H, :W]


class LayerNorm2d(LayerNorm):
    """SAM's LayerNorm2d on NHWC: per-pixel channel norm, eps 1e-6, fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) / torch.sqrt(var + 1e-6)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class SAMEncoder(nn.Module):
    def __init__(self, variant: SAMVariant = SAM_VITB):
        super().__init__()
        self.variant = variant
        w = variant.width
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(3, w, variant.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, variant.grid, variant.grid, w))
        self.blocks = nn.ModuleList(
            Block(w, variant.heads, 0 if i in variant.global_blocks else variant.window,
                  variant.grid if i in variant.global_blocks else variant.window)
            for i in range(variant.layers))
        oc = variant.out_chans
        self.neck = nn.ModuleDict({"0": Conv(w, oc, 1, bias=False), "1": LayerNorm2d(oc),
                                   "2": Conv(oc, oc, 3, bias=False), "3": LayerNorm2d(oc)})

    def forward(self, images: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, H / patch, W / patch, out_chans) neck
        output, one image at a time."""
        return torch.cat([self._encode(im[None], compute_dtype) for im in images])

    def _encode(self, images: torch.Tensor, dt) -> torch.Tensor:
        v = self.variant
        x = conv2d(images.to(dt), self.patch_embed.proj.weight, self.patch_embed.proj.bias, stride=v.patch)
        pe = self.pos_embed
        if tuple(x.shape[1:3]) != tuple(pe.shape[1:3]):
            pe = resize_bicubic(pe.float(), tuple(x.shape[1:3])).to(pe.dtype)
        x = x + pe.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        n = self.neck
        x = n["1"](conv2d(x, n["0"].weight))
        return n["3"](conv2d(x, n["2"].weight, padding=1))


@torch.no_grad()
def init_sam_(sam: SAMEncoder, gen: torch.Generator) -> SAMEncoder:
    """Seeded init with catseg_tpu's init_sam_params scales: patch, qkv,
    proj, MLP and neck weights N(0, 0.02); biases, the positional embedding
    and the rel-pos tables 0; norms 1 / 0."""
    for name, p in sam.named_parameters():
        if name.endswith(".weight") and ("norm" in name or name.startswith(("neck.1", "neck.3"))):
            p.fill_(1.0)
        elif name.endswith(".weight"):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        else:
            p.zero_()
    return sam
