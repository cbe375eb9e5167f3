"""Windowed multi-head attention over projected q/k/v: CUDA kernel + plain
PyTorch version.

Replaces catseg_tpu/kernels/window_attn.py:fused_window_attention (Pallas
_kernel), which the unfused Swin block (core/aggregator.py ``_swin_block``)
runs.  The kernel (csrc/window_attn.cu) keeps each window's (N, N) logits
on chip; its note there says what bounds it on the card.  The reference has
no shape gate here, so every call goes through the kernel on CUDA.

Arithmetic, in both dtypes as the reference's kernel: fp32 logits scaled
after the q.k product, the additive fp32 mask, a max-subtracted fp32
softmax, the probabilities rounded to the input dtype before the fp32 value
product.

Gradients: the kernel call sits in a ``torch.autograd.Function`` whose
backward is autograd through the plain version on every device (the
reference's ``_bwd`` is a plain fp32 recompute); the mask gets none.
"""

from __future__ import annotations

import torch

from . import _build
from .autograd import plain_vjp

MAX_TOKENS = 256           # tokens per window the kernel takes (kMaxN in csrc/window_attn.cu)
HEAD_DIMS = (8, 16, 32, 64)


def window_attention_plain(q, k, v, mask, heads: int, scale: float) -> torch.Tensor:
    """softmax(scale * q k^T + mask) v over windows: q/k/v (Bw, N, C) with
    Bw a multiple of nW; mask (nW, N, N) fp32, window w takes mask[w % nW]."""
    Bw, N, C = q.shape
    D = C // heads
    nW = mask.shape[0]
    qh, kh, vh = (t.float().reshape(Bw, N, heads, D).transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    logits = (logits.reshape(Bw // nW, nW, heads, N, N) + mask.float()[None, :, None]).reshape(Bw, heads, N, N)
    attn = torch.softmax(logits, dim=-1).to(q.dtype).float()
    return torch.matmul(attn, vh).to(q.dtype).transpose(1, 2).reshape(Bw, N, C)


def _window_attention_cuda(q, k, v, mask, heads: int, scale: float) -> torch.Tensor:
    Bw, N, C = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window attention kernel takes fp32 or bf16, got {q.dtype}")
    if not (k.shape == v.shape == q.shape and k.dtype == v.dtype == q.dtype):
        raise ValueError("q, k, v must share shape and dtype")
    nW = mask.shape[0]
    if mask.shape != (nW, N, N) or Bw % nW:
        raise ValueError(f"mask {tuple(mask.shape)} does not fit {Bw} windows of {N} tokens")
    if C % heads or C // heads not in HEAD_DIMS or N > MAX_TOKENS:
        raise NotImplementedError(f"window attention kernel takes head dims {HEAD_DIMS} and at most "
                                  f"{MAX_TOKENS} tokens; got C={C}, heads={heads}, N={N}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 32 for t in (q, k, v)):
        raise ValueError("window attention kernel reads q, k, v in 32-byte tiles: pass aligned tensors")
    out = torch.empty_like(q)
    _build.launch("catseg_window_attention", q, k, v, mask.float().contiguous(), out, Bw, N, C, heads, nW,
                  float(scale), int(q.dtype == torch.bfloat16))
    _build.count("window_attention")
    return out


class _WindowAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, heads, scale):
        ctx.save_for_backward(q, k, v, mask)
        ctx.cfg = (heads, scale)
        if q.is_cuda:
            return _window_attention_cuda(q, k, v, mask, heads, scale)
        if q.device.type == "cpu":
            return window_attention_plain(q, k, v, mask, heads, scale)
        raise RuntimeError(f"no window attention path for device {q.device}")

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        heads, scale = ctx.cfg
        dq, dk, dv = plain_vjp(lambda q, k, v: window_attention_plain(q, k, v, mask, heads, scale), [q, k, v], g)
        return dq, dk, dv, None, None, None


def fused_window_attention(q, k, v, mask, heads: int, scale: float) -> torch.Tensor:
    """softmax(scale * q k^T + mask) v over windows; q/k/v (Bw, N, C), mask
    (nW, N, N) additive fp32 (zeros when unshifted); returns (Bw, N, C) in
    q's dtype."""
    return _WindowAttentionFn.apply(q, k, v, mask, heads, scale)
