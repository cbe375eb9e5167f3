"""Cosine cost volume + 7x7 correlation embedding: CUDA kernel + plain
PyTorch version.

Replaces catseg_tpu/kernels/corr_embed.py:fused_corr_embed (Pallas _kernel).
The kernel (csrc/corr_embed.cu) never writes the (B, T, H, W, P) cost volume;
its note there says what bounds it on the card.  Weights use the reference's
HWIO layout so the two packages are called alike; the bf16 kernel takes them
packed (:func:`pack_taps`).  The kernel takes every geometry the
reference's gate (:func:`corr_embed_applicable`) takes with one prompt: a
24x24 grid, an embed width C a multiple of 128 (walked in 128-channel
blocks) and a text width E a multiple of 8 (:func:`kernel_takes`).  A CUDA
call outside it raises; the aggregator calls the wrapper wherever the
reference's gate holds.

Gradients: the kernel call sits in a ``torch.autograd.Function`` whose
backward is autograd through the plain version (catseg_tpu/kernels/
corr_embed.py ``_bwd``: the vjp of ``_reference``), on every device.
Where no gradient is recorded, the wrapper calls the op
``catseg_tpu_torch::corr_embed`` (``kernels/ops.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .autograd import plain_vjp
from .ops import records_grad, register, serve
from .swin_block import pack_mma_b

BASE = 24   # feature grid the kernel is written for
MAX_P = 1   # single prompt per class


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics in fp32, result in the input dtype."""
    x32 = x.float()
    n = x32.square().sum(dim, keepdim=True).sqrt()
    return (x32 / n.clamp_min(eps)).to(x.dtype)


def kernel_takes(H: int, W: int, P: int, C: int, E: int) -> bool:
    """The geometry the CUDA kernel is built for: a 24x24 grid, one prompt
    (P = 1), C a positive multiple of 128 embed channels, E a positive
    multiple of 8 (16-byte rows in bf16)."""
    return (H, W, P) == (BASE, BASE, 1) and C > 0 and C % 128 == 0 and E > 0 and E % 8 == 0


def corr_embed_applicable(img_feats: torch.Tensor, text_feats: torch.Tensor, w: torch.Tensor) -> bool:
    """The reference's gate: P <= 1 and, at one prompt, the kernel's
    geometry (a 24x24 grid, C % 128, E % 8)."""
    _, H, W, E = img_feats.shape
    return text_feats.shape[2] <= MAX_P and kernel_takes(H, W, 1, w.shape[-1], E)


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


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """(7, 7, 1, C) HWIO taps -> the bf16 kernel's B operand: the (64, C) tap
    matrix, row dy * 8 + dx (rows with dy = 7 or dx = 7 zero), rounded to bf16
    and packed in mma fragment order (``swin_block.pack_mma_b``, depth 16):
    each 128-channel block is 16 n8 tiles, read by the kernel in turn."""
    C = w.shape[-1]
    w64 = torch.zeros(8, 8, C, dtype=torch.bfloat16, device=w.device)
    w64[:7, :7] = w[:, :, 0, :].to(torch.bfloat16)
    return pack_mma_b(w64.reshape(64, C), depth=16)


def _corr_embed_cuda(img_feats, text_n, w, b) -> torch.Tensor:
    B, H, W, E = img_feats.shape
    T, P = text_n.shape[1], text_n.shape[2]
    C = w.shape[-1]
    dt = img_feats.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr embed kernel takes fp32 or bf16, got {dt}")
    if not kernel_takes(H, W, P, C, E):
        raise NotImplementedError(f"corr embed kernel is built for 24x24, P=1, C a multiple of 128 and E a "
                                  f"multiple of 8; got {(H, W, P, C)}, E={E}")
    img = img_feats.contiguous()
    txt = text_n.reshape(B, T, E).to(dt).contiguous()
    if img.data_ptr() % 16 or txt.data_ptr() % 16:
        raise ValueError("corr embed kernel reads image and text rows by 16-byte loads: both must start 16-byte "
                         f"aligned; got addresses mod 16 {img.data_ptr() % 16}, {txt.data_ptr() % 16}")
    taps = pack_taps(w) if dt == torch.bfloat16 else w.float().reshape(49, C).contiguous()
    bias = b.float().contiguous()
    imgn = torch.empty((B, H * W, E), dtype=dt, device=img.device)   # the normalized image, once per image
    out = torch.empty((B, T, H, W, C), dtype=dt, device=img.device)
    _build.launch("catseg_corr_embed", img, txt, taps, bias, imgn, out, B, T, H, W, C, E, int(dt == torch.bfloat16))
    _build.count("corr_embed")
    return out


class _CorrEmbedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img_feats, text_n, w, b):
        ctx.save_for_backward(img_feats, text_n, w, b)
        if img_feats.is_cuda:
            return _corr_embed_cuda(img_feats, text_n, w, b)
        if img_feats.device.type == "cpu":
            return corr_embed_plain(img_feats, text_n, w, b)
        raise RuntimeError(f"no corr embed path for device {img_feats.device}")

    @staticmethod
    def backward(ctx, g):
        return tuple(plain_vjp(corr_embed_plain, ctx.saved_tensors, g))


def _corr_embed_fake(img_feats, text_n, w, b):
    B, H, W, _ = img_feats.shape
    return img_feats.new_empty((B, text_n.shape[1], H, W, w.shape[-1]))


corr_embed_op = register("corr_embed", "(Tensor img_feats, Tensor text_n, Tensor w, Tensor b) -> Tensor",
                         corr_embed_plain, _corr_embed_cuda, _corr_embed_fake)


def fused_corr_embed(img_feats: torch.Tensor, text_n: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """L2-normalized cosine cost volume + 7x7 embedding (B, T, 24, 24, C);
    text_n must already be L2-normalized (the caller normalizes once)."""
    if records_grad(img_feats, text_n, w, b):
        return _CorrEmbedFn.apply(img_feats, text_n, w, b)
    return serve(corr_embed_op, "corr embed", img_feats, text_n, w, b)
