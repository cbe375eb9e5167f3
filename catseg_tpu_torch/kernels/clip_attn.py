"""Maskless multi-head attention for the dense CLIP encode: CUDA kernel +
plain PyTorch version.

Replaces catseg_tpu/kernels/clip_attn.py:fused_dense_attention (Pallas
_kernel).  The kernel (csrc/clip_attn.cu) keeps the (S, S) fp32 logits out of
device memory with an online softmax over 64-key tiles: in bf16 on the tensor
cores (mma.sync, S and P in registers, FlashAttention-2 order), in fp32 on
CUDA cores in register tiles.  Its note there says what bounds it on the card.

Gradients: the kernel call sits in a ``torch.autograd.Function`` whose
backward is the reference's plain fp32 recompute (catseg_tpu/kernels/
clip_attn.py ``_bwd``), plain PyTorch on every device, as the reference has
no backward kernel.  Where no gradient is recorded, the wrapper calls the
op ``catseg_tpu_torch::dense_attention`` (``kernels/ops.py``).
"""

from __future__ import annotations

import torch

from . import _build
from .ops import records_grad, register, serve


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
    # the kernel reads rows by 16-byte copies (W * itemsize is a multiple of
    # 16), so each tensor must start 16-byte aligned
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("dense attention kernel reads q, k, v rows in 16-byte pieces: each must start "
                         f"16-byte aligned; got addresses mod 16 {[t.data_ptr() % 16 for t in (q, k, v)]}")
    out = torch.empty_like(q)
    D = W // heads
    _build.launch("catseg_dense_attention", q, k, v, out, B, S, W, heads, D, D ** -0.5,
                  int(q.dtype == torch.bfloat16))
    _build.count("dense_attention")
    return out


def dense_attention_backward(q, k, v, g, heads: int):
    """(dq, dk, dv): the reference's ``_bwd``, fp32 softmax recomputed."""
    B, S, W = q.shape
    D = W // heads
    scale = D ** -0.5
    qh, kh, vh, gh = (t.float().reshape(B, S, heads, D) for t in (q, k, v, g))
    attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", attn, gh)
    dattn = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    dlogits = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dlogits, kh) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dlogits, qh) * scale
    return (dq.reshape(B, S, W).to(q.dtype), dk.reshape(B, S, W).to(k.dtype),
            dv.reshape(B, S, W).to(v.dtype))


class _DenseAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.save_for_backward(q, k, v)
        ctx.heads = heads
        if q.is_cuda:
            return _dense_attention_cuda(q, k, v, heads)
        if q.device.type == "cpu":
            return dense_attention_plain(q, k, v, heads)
        raise RuntimeError(f"no dense attention path for device {q.device}")

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*dense_attention_backward(q, k, v, g, ctx.heads), None)


dense_attention_op = register("dense_attention", "(Tensor q, Tensor k, Tensor v, int heads) -> Tensor",
                              dense_attention_plain, _dense_attention_cuda,
                              lambda q, k, v, heads: torch.empty_like(q))


def fused_dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Maskless MHA over (B, S, W) sequences; requires W // heads == 64."""
    if records_grad(q, k, v):
        return _DenseAttentionFn.apply(q, k, v, heads)
    return serve(dense_attention_op, "dense attention", q, k, v, heads)
