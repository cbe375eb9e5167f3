"""Maskless multi-head attention for the dense CLIP encode: CUDA kernel +
plain PyTorch version.

Replaces catseg_tpu/kernels/clip_attn.py:fused_dense_attention (Pallas
_kernel).  The kernel (csrc/clip_attn.cu) keeps the (S, S) fp32 logits out of
device memory with an online softmax over 32-key tiles; its note there says
what bounds it on the card.
"""

from __future__ import annotations

import torch

from . import _build


def dense_attention_applicable(W: int, heads: int, mask) -> bool:
    """The reference's gate: maskless, head_dim 64 (ViT-B/16, ViT-L/14)."""
    return mask is None and W % 128 == 0 and W % heads == 0 and W // heads == 64


def dense_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T * D^-1/2) v on (B, S, W); fp32 logits and softmax, the
    probabilities rounded to the input dtype before the value product."""
    B, S, W = q.shape
    D = W // heads
    qh, kh, vh = (t.float().reshape(B, S, heads, D).transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * (D ** -0.5)
    attn = torch.softmax(logits, dim=-1).to(q.dtype).float()
    out = torch.matmul(attn, vh).to(q.dtype)
    return out.transpose(1, 2).reshape(B, S, W)


def _dense_attention_cuda(q, k, v, heads: int) -> torch.Tensor:
    B, S, W = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dense attention kernel takes fp32 or bf16, got {q.dtype}")
    if not (k.shape == v.shape == q.shape and k.dtype == v.dtype == q.dtype):
        raise ValueError("q, k, v must share shape and dtype")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    D = W // heads
    _build.launch("catseg_dense_attention", q, k, v, out, B, S, W, heads, D, D ** -0.5,
                  int(q.dtype == torch.bfloat16))
    _build.count("dense_attention")
    return out


def fused_dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Maskless MHA over (B, S, W) sequences; requires W // heads == 64."""
    if q.is_cuda:
        return _dense_attention_cuda(q, k, v, heads)
    if q.device.type == "cpu":
        return dense_attention_plain(q, k, v, heads)
    raise RuntimeError(f"no dense attention path for device {q.device}")
