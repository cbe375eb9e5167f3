"""Row LayerNorm with fp32 statistics: Triton kernel + plain PyTorch version.

Replaces catseg_tpu/kernels/layer_norm.py:fused_layer_norm (Pallas _kernel).
Bound on the card: device-memory bandwidth (one read and one write per
element, ~5 flops each).  The kernel normalizes BLOCK_M rows per program in
registers, so the activation crosses device memory exactly twice instead of
once per upcast / mean / variance / normalize pass.

Variance follows the reference's dtype gate: single-pass E[x^2] - mu^2 when
the input is bf16, two-pass when it is fp32.  The output keeps the input
dtype; gamma and beta are applied in fp32.

Gradients: the kernel call sits in a ``torch.autograd.Function`` whose
backward is the reference's analytic formula (catseg_tpu/kernels/
layer_norm.py ``_bwd``: fp32 statistics recomputed from x), plain PyTorch on
every device, as the reference has no backward kernel.
"""

from __future__ import annotations

import functools

import torch

from . import _build

_MIN_ROWS = 512  # the reference's gate: C % 128 == 0 and at least one 512-row tile


def layer_norm_fp32(x32: torch.Tensor, g: torch.Tensor, b: torch.Tensor, fast: bool,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of fp32 rows with an fp32 result; ``fast`` (bf16 compute)
    takes the single-pass variance E[x^2] - mu^2, otherwise two-pass."""
    mean = x32.mean(-1, keepdim=True)
    if fast:
        var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    else:
        var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * g.float() + b.float()


def layer_norm_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return layer_norm_fp32(x.float(), g, b, x.dtype == torch.bfloat16, eps).to(x.dtype)


def kernel_applicable(x: torch.Tensor) -> bool:
    C = x.shape[-1]
    return C % 128 == 0 and x.numel() // C >= _MIN_ROWS


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def ln_kernel(x_ptr, g_ptr, b_ptr, o_ptr, M, C, eps,
                  BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr, FAST: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        mask = (rows[:, None] < M) & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / C
        if FAST:
            var = tl.sum(x * x, axis=1) / C - mean * mean
        else:
            d = tl.where(mask, x - mean[:, None], 0.0)
            var = tl.sum(d * d, axis=1) / C
        rstd = 1.0 / tl.sqrt(var + eps)
        g = tl.load(g_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        y = (x - mean[:, None]) * rstd[:, None] * g[None, :] + b[None, :]
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)

    return ln_kernel


def _layer_norm_cuda(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    import triton

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel takes fp32 or bf16, got {x.dtype}")
    C = x.shape[-1]
    x2 = x.contiguous().view(-1, C)
    M = x2.shape[0]
    out = torch.empty_like(x2)
    block_c = triton.next_power_of_2(C)
    block_m = max(1, 4096 // block_c)
    grid = (triton.cdiv(M, block_m),)
    _triton_kernel()[grid](x2, g.float().contiguous(), b.float().contiguous(), out, M, C, eps,
                           BLOCK_M=block_m, BLOCK_C=block_c, FAST=x.dtype == torch.bfloat16,
                           num_warps=4)
    _build.count("layer_norm")
    return out.view(x.shape)


def layer_norm_backward(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5):
    """(dx, dg, db) of the LayerNorm: the reference's analytic ``_bwd``."""
    x32, dy32 = x.float(), dy.float()
    mean = x32.mean(-1, keepdim=True)
    if x.dtype == torch.bfloat16:
        var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    else:
        var = (x32 - mean).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * inv
    lead = tuple(range(x.ndim - 1))
    dxhat = dy32 * g.float()
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), (dy32 * xhat).sum(lead).to(g.dtype), dy32.sum(lead).to(g.dtype)


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        if x.is_cuda:
            return _layer_norm_cuda(x, g, b, eps)
        if x.device.type == "cpu":
            return layer_norm_plain(x, g, b, eps)
        raise RuntimeError(f"no layer_norm path for device {x.device}")

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        dx, dg, db = layer_norm_backward(x, g, dy, ctx.eps)
        return dx, dg, db, None


def fused_layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics, any leading shape.

    Shapes outside the reference's kernel gate take the plain version on
    every device, as the reference does."""
    if not kernel_applicable(x):
        return layer_norm_plain(x, g, b, eps)
    return _LayerNormFn.apply(x, g, b, eps)
