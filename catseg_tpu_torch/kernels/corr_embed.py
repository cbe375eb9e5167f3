"""Cosine cost volume + 7x7 correlation embedding: CUDA kernel + plain
PyTorch version.

Replaces catseg_tpu/kernels/corr_embed.py:fused_corr_embed (Pallas _kernel).
The kernel (csrc/corr_embed.cu) never writes the (B, T, H, W, P) cost volume;
its note there says what bounds it on the card.  Weights use the reference's
HWIO layout so the two packages are called alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

BASE = 24   # feature grid the kernel is written for
MAX_P = 1   # single prompt per class


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics in fp32, result in the input dtype."""
    x32 = x.float()
    n = x32.square().sum(dim, keepdim=True).sqrt()
    return (x32 / n.clamp_min(eps)).to(x.dtype)


def corr_embed_applicable(img_feats: torch.Tensor, text_feats: torch.Tensor, w: torch.Tensor) -> bool:
    """The reference's gate: 24x24 grid, 128-multiple embed width, P <= 1."""
    return (img_feats.shape[1] == BASE and img_feats.shape[2] == BASE
            and w.shape[-1] % 128 == 0 and text_feats.shape[2] <= MAX_P
            and img_feats.shape[-1] % 8 == 0)


def corr_embed_plain(img_feats: torch.Tensor, text_n: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """img_feats (B, H, W, E) raw, text_n (B, T, P, E) normalized, w (7, 7, P, C)
    HWIO, b (C,) -> (B, T, H, W, C) in img_feats.dtype."""
    B, H, W, E = img_feats.shape
    T, P = text_n.shape[1], text_n.shape[2]
    dt = img_feats.dtype
    img = l2_normalize(img_feats).float()
    corr = torch.einsum("bhwc,btpc->btphw", img, text_n.to(dt).float()).to(dt)
    x = F.conv2d(corr.reshape(B * T, P, H, W), w.permute(3, 2, 0, 1).to(dt), padding=3)
    x = (x.float() + b.float()[:, None, None]).to(dt)
    return x.reshape(B, T, -1, H, W).permute(0, 1, 3, 4, 2)


def _corr_embed_cuda(img_feats, text_n, w, b) -> torch.Tensor:
    B, H, W, E = img_feats.shape
    T, P = text_n.shape[1], text_n.shape[2]
    C = w.shape[-1]
    dt = img_feats.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr embed kernel takes fp32 or bf16, got {dt}")
    if (H, W, P, C) != (BASE, BASE, 1, 128):
        raise NotImplementedError(f"corr embed kernel is built for 24x24, P=1, C=128; got {(H, W, P, C)}")
    img = img_feats.contiguous()
    txt = text_n.reshape(B, T, E).to(dt).contiguous()
    w49 = w.to(dt).float().reshape(49, C).contiguous()
    bias = b.float().contiguous()
    out = torch.empty((B, T, H, W, C), dtype=dt, device=img.device)
    _build.launch("catseg_corr_embed", img, txt, w49, bias, out, B, T, H, W, E, int(dt == torch.bfloat16))
    _build.count("corr_embed")
    return out


def fused_corr_embed(img_feats: torch.Tensor, text_n: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """L2-normalized cosine cost volume + 7x7 embedding (B, T, 24, 24, C);
    text_n must already be L2-normalized (the caller normalizes once)."""
    if img_feats.is_cuda:
        return _corr_embed_cuda(img_feats, text_n, w, b)
    if img_feats.device.type == "cpu":
        return corr_embed_plain(img_feats, text_n, w, b)
    raise RuntimeError(f"no corr embed path for device {img_feats.device}")
