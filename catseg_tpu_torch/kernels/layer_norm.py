"""Row LayerNorm with fp32 statistics: CUDA kernel + plain PyTorch version.

Replaces catseg_tpu/kernels/layer_norm.py:fused_layer_norm (Pallas _kernel).
The kernel, csrc/layer_norm.cu, is bound by device-memory bytes (one read
and one write of every element); its note says how it keeps them in
flight.  Any row count and any row width that is a multiple of 8 (bf16) or
4 (fp32) up to 4096 / 2048 elements goes in whole, with no padding to a
power of two (:func:`kernel_takes`).  A CUDA call is routed by geometry
before any launch (:func:`route`): the kernel wherever it takes the width,
whatever the reference's TPU tile gate (C a multiple of 128, at least 512
rows) says; elsewhere the plain version where that gate fails, as the
reference runs its ``_reference_ln`` there (bf16 rows of 100, say), and a
raise where it holds (a width the reference's kernel takes and the port's
does not: past 4096 / 2048).  A CPU tensor always takes the plain version.

Variance follows the reference's dtype gate: single-pass E[x^2] - mu^2 when
the input is bf16, two-pass when it is fp32.  The output keeps the input
dtype; gamma and beta are applied in fp32.

Gradients: the kernel call sits in a ``torch.autograd.Function`` whose
backward is the reference's analytic formula (catseg_tpu/kernels/
layer_norm.py ``_bwd``: fp32 statistics recomputed from x), plain PyTorch on
every device, as the reference has no backward kernel.  Where no gradient
is recorded (serving), the wrapper calls the op ``catseg_tpu_torch::
layer_norm`` (``kernels/ops.py``): the kernel on a CUDA tensor, the plain
version on a CPU one; fp32 contiguous gamma / beta (the model's parameters)
pass without a copy.
"""

from __future__ import annotations

import torch

from . import _build
from .ops import records_grad, register, serve

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


def kernel_takes(C: int, dtype: torch.dtype) -> bool:
    """The row widths the CUDA kernel takes: whole 16-byte vectors, a
    multiple of 8 up to 4096 in bf16 or of 4 up to 2048 in fp32."""
    if dtype == torch.bfloat16:
        return 0 < C <= 4096 and C % 8 == 0
    return dtype == torch.float32 and 0 < C <= 2048 and C % 4 == 0


def reference_gate(C: int, M: int) -> bool:
    """Where the reference runs its Pallas kernel (catseg_tpu/kernels/
    layer_norm.py ``fused_layer_norm``): C % 128 == 0 and M >= 512 rows."""
    return C % 128 == 0 and M >= 512


def route(C: int, M: int, dtype: torch.dtype) -> str:
    """What a CUDA call of M rows of C runs: "kernel" where the kernel takes
    the width, else "plain" where the reference runs its plain composition,
    else "raise" (the reference's kernel takes it, the port's does not)."""
    if kernel_takes(C, dtype):
        return "kernel"
    return "raise" if reference_gate(C, M) else "plain"


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _layer_norm_cuda(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel takes fp32 or bf16, got {x.dtype}")
    C = x.shape[-1]
    way = route(C, x.numel() // max(C, 1), x.dtype)
    if way == "plain":
        return layer_norm_plain(x, g, b, eps)
    if way == "raise":
        raise NotImplementedError(f"layer_norm kernel takes rows of a multiple of 8 bf16 (up to 4096) or 4 fp32 "
                                  f"(up to 2048) elements; got {C} {x.dtype}, where the reference's kernel runs")
    x, g, b = x.contiguous(), _f32(g), _f32(b)
    # rows, gamma and beta are read as 16-byte vectors
    if any(t.data_ptr() % 16 for t in (x, g, b)):
        raise ValueError(f"layer_norm kernel reads 16-byte vectors: x, gamma and beta must start 16-byte aligned; "
                         f"got addresses mod 16 {[t.data_ptr() % 16 for t in (x, g, b)]}")
    out = torch.empty_like(x)
    _build.launch("catseg_layer_norm", x, g, b, out, x.numel() // C, C, eps,
                  int(x.dtype == torch.bfloat16))
    _build.count("layer_norm")
    return out


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


layer_norm_op = register("layer_norm", "(Tensor x, Tensor g, Tensor b, float eps) -> Tensor", layer_norm_plain,
                         _layer_norm_cuda, lambda x, g, b, eps: torch.empty_like(x))


def fused_layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics, any leading shape: on a
    CUDA tensor what :func:`route` says, the plain version on a CPU one."""
    if records_grad(x, g, b):
        return _LayerNormFn.apply(x, g, b, eps)
    return serve(layer_norm_op, "layer_norm", x, g, b, eps)
