"""Windowed multi-head attention over projected q/k/v: CUDA kernel + plain
PyTorch version.

Replaces catseg_tpu/kernels/window_attn.py:fused_window_attention (Pallas
_kernel), which the unfused Swin block (core/aggregator.py ``_swin_block``)
runs.  The kernel (csrc/window_attn.cu) keeps each window's (N, N) logits
on chip; its note there says what bounds it on the card.  The reference has
no shape gate here: every call on a CUDA tensor launches the kernel, or
raises outside :func:`kernel_takes` (at most 256 tokens a window, at any
width and head dim).  Head dims 16, 32, 48, 64, 96 and 128 in bf16 run on
the tensor cores where the window fits (:func:`takes_tensor_cores`),
everything else (fp32, and bf16 at any other head dim: 3, 24, 25, 192,
256, 512, ...) on a CUDA-core path with the same arithmetic.

Arithmetic, in both dtypes as the reference's kernel: fp32 logits scaled
after the q.k product, the additive fp32 mask (none for an unshifted block:
``mask=None`` skips the add, bit-equal to a zero mask), a max-subtracted fp32
softmax, the probabilities normalised, then rounded to the input dtype
before the fp32 value product (on the bf16 tensor cores, rows of more than
144 keys take FlashAttention's order: P rounded before it is normalised,
within the same 2^-5 bound; csrc/window_attn.cu says why).  q, k and v may be views whose rows are
evenly strided (the unfused Swin block's split of its fused qkv
projection): the kernel takes each one's row stride, any number of
elements, so nothing is copied (rows off the 16-byte grid, e.g. hidden
100's 300 apart, leave the tensor cores for a CUDA-core path).

Gradients: the kernel call sits in a ``torch.autograd.Function`` whose
backward is autograd through the plain version on every device (the
reference's ``_bwd`` is a plain fp32 recompute); the mask gets none.
"""

from __future__ import annotations

import torch

from . import _build
from .autograd import plain_vjp
from .ops import records_grad, register, serve

MAX_TOKENS = 256           # tokens per window the kernel takes (kMaxN in csrc/window_attn.cu)


def window_attention_plain(q, k, v, mask, heads: int, scale: float) -> torch.Tensor:
    """softmax(scale * q k^T + mask) v over windows: q/k/v (Bw, N, C) with
    Bw a multiple of nW; mask (nW, N, N) fp32, window w takes mask[w % nW],
    or None for zeros (the add is skipped: adding 0.0 is exact)."""
    Bw, N, C = q.shape
    D = C // heads
    qh, kh, vh = (t.float().reshape(Bw, N, heads, D).transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if mask is not None:
        nW = mask.shape[0]
        logits = (logits.reshape(Bw // nW, nW, heads, N, N) + mask.float()[None, :, None]).reshape(Bw, heads, N, N)
    attn = torch.softmax(logits, dim=-1).to(q.dtype).float()
    return torch.matmul(attn, vh).to(q.dtype).transpose(1, 2).reshape(Bw, N, C)


def kernel_takes(N: int, C: int, heads: int) -> bool:
    """The geometry the CUDA kernel takes, in both dtypes and at any row
    stride: at most MAX_TOKENS tokens a window, any width and head dim.
    Rows that are not evenly strided are copied by the wrapper first."""
    return C % heads == 0 and N <= MAX_TOKENS


def _window_attention_cuda(q, k, v, mask, heads: int, scale: float) -> torch.Tensor:
    Bw, N, C = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window attention kernel takes fp32 or bf16, got {q.dtype}")
    if not (k.shape == v.shape == q.shape and k.dtype == v.dtype == q.dtype):
        raise ValueError("q, k, v must share shape and dtype")
    nW = 1
    if mask is not None:
        nW = mask.shape[0]
        if mask.shape != (nW, N, N) or Bw % nW:
            raise ValueError(f"mask {tuple(mask.shape)} does not fit {Bw} windows of {N} tokens")
        mask = mask.float().contiguous()
    if not kernel_takes(N, C, heads):
        raise NotImplementedError(f"window attention kernel takes at most {MAX_TOKENS} tokens a window and C a "
                                  f"multiple of the heads; got C={C}, heads={heads}, N={N}")
    # rows may be strided (views of a fused qkv projection), by any number of
    # elements: the kernel takes each tensor's row stride
    q, k, v = (t if _build.rows_evenly_strided(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty((Bw, N, C), dtype=q.dtype, device=q.device)
    _build.launch("catseg_window_attention", q, k, v, mask, out, Bw, N, C, heads, nW,
                  q.stride(1), k.stride(1), v.stride(1), float(scale), int(q.dtype == torch.bfloat16))
    _build.count("window_attention")
    return out


def takes_tensor_cores(N: int, C: int, heads: int, dtype: torch.dtype) -> bool:
    """Whether the kernel runs this geometry on the tensor-core path (bf16,
    N % 16 == 0, head dim 16 / 32 / 48 / 64 / 96 / 128, the window's K and V
    within the current device's shared memory: not at 4 heads of 128, whose
    144 tokens' K and V take 295 KB; those take the CUDA-core path), given rows
    16-byte aligned and a multiple of 8 elements apart."""
    return bool(_build.library().catseg_window_attention_tensor_cores(N, C, heads, int(dtype == torch.bfloat16)))


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


window_attention_op = register(
    "window_attention", "(Tensor q, Tensor k, Tensor v, Tensor? mask, int heads, float scale) -> Tensor",
    window_attention_plain, _window_attention_cuda,
    lambda q, k, v, mask, heads, scale: q.new_empty(q.shape))


def fused_window_attention(q, k, v, mask, heads: int, scale: float) -> torch.Tensor:
    """softmax(scale * q k^T + mask) v over windows; q/k/v (Bw, N, C), mask
    (nW, N, N) additive fp32, or None when unshifted (as zeros); returns
    (Bw, N, C) in q's dtype.  Where no gradient is recorded, the op
    ``catseg_tpu_torch::window_attention`` (``kernels/ops.py``)."""
    if records_grad(q, k, v, mask):
        return _WindowAttentionFn.apply(q, k, v, mask, heads, scale)
    return serve(window_attention_op, "window attention", q, k, v, mask, heads, scale)
