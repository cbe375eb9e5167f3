"""elu+1 linear attention across the class axis: CUDA kernel + plain PyTorch
version.

Replaces catseg_tpu/kernels/linear_attn.py:fused_linear_attention (Pallas
_kernel), which the unfused linear class stage (core/aggregator.py
``_class_attention_inner``) runs.  The kernel (csrc/linear_attn.cu) builds
each sequence's per-head KV and K-sum on chip; its note there says what
bounds it on the card.

The kernel takes any S and the head dims and widths :func:`kernel_takes`
names: the HEAD_DIMS 8, 16, 32, 64, 128 on the tensor cores, and every
head dim at C a multiple of 128 up to 512 (so everywhere the reference's
gate holds up to that width) on an fp32 CUDA-core path
(csrc/linear_attn.cu).  A call is routed by geometry alone, before any
launch (:func:`route`): on a CUDA tensor the kernel runs where it takes the
geometry; elsewhere the plain version runs where the reference's own Pallas
gate fails (:func:`reference_gate`: C % 128 == 0 and S % 8 == 0), as the
reference runs its ``_reference`` there, and the call raises where that gate
holds (a geometry the reference runs on its kernel and the port's does not
take).  A CPU tensor always takes the plain version.

Gradients: the kernel call sits in a ``torch.autograd.Function`` whose
backward is autograd through the plain version on every device, as the
reference's ``_bwd`` is ``jax.vjp`` of its ``_reference``.
"""

from __future__ import annotations

import torch

from . import _build
from .autograd import plain_vjp
from .ops import records_grad, register, serve
from .class_layer import _elu1

_EPS = 1e-6
HEAD_DIMS = (8, 16, 32, 64, 128)   # the tensor-core path's
MAX_WIDTH = 512   # every head dim is taken at C % 128 == 0 up to this width


def linear_attention_plain(q, k, v, heads: int) -> torch.Tensor:
    """q/k/v (N, S, C) -> (N, S, C): Q = elu(q)+1, K = elu(k)+1, V = v / S in
    fp32; (Q KV_h) / (Q . Ksum_h + 1e-6) * S per head, in q's dtype."""
    N, S, C = q.shape
    D = C // heads
    Q = _elu1(q.float()).reshape(N, S, heads, D)
    K = _elu1(k.float()).reshape(N, S, heads, D)
    V = (v.float() / S).reshape(N, S, heads, D)
    kv = torch.einsum("nshd,nshe->nhde", K, V)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(1)) + _EPS)
    out = torch.einsum("nlhd,nhde->nlhe", Q, kv) * z[..., None] * S
    return out.to(q.dtype).reshape(N, S, C)


def kernel_takes(C: int, heads: int) -> bool:
    """The kernel's geometry: HEAD_DIMS on the tensor cores, where a
    CTA takes 128 channels (or all of a narrower C) in column groups of
    max(head dim, 16), so head dim 128 is one head at C = 128 or any
    multiple of 128; and every head dim at C a multiple of 128 up to
    MAX_WIDTH (the CUDA-core path: 1, 3, 24, 48, 96, 256, ...)."""
    if C % heads:
        return False
    D = C // heads
    if D in HEAD_DIMS and C % max(D, 16) == 0 and (C <= 128 or C % 128 == 0):
        return True
    return C % 128 == 0 and C <= MAX_WIDTH


def reference_gate(C: int, S: int) -> bool:
    """Where the reference runs its Pallas kernel (catseg_tpu/kernels/
    linear_attn.py ``fused_linear_attention``): C % 128 == 0, S % 8 == 0."""
    return C % 128 == 0 and S % 8 == 0


def route(C: int, heads: int, S: int) -> str:
    """What a CUDA call at this geometry runs: "kernel" where the kernel
    takes it, else "plain" where the reference runs its plain composition,
    else "raise" (the reference's kernel takes it, the port's does not)."""
    if kernel_takes(C, heads):
        return "kernel"
    return "raise" if reference_gate(C, S) else "plain"


def _linear_attention_cuda(q, k, v, heads: int) -> torch.Tensor:
    N, S, C = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"linear attention kernel takes fp32 or bf16, got {q.dtype}")
    if not (k.shape == v.shape == q.shape and k.dtype == v.dtype == q.dtype):
        raise ValueError("q, k, v must share shape and dtype")
    way = route(C, heads, S)
    if way == "plain":
        return linear_attention_plain(q, k, v, heads)
    if way == "raise":
        raise NotImplementedError(f"linear attention kernel takes every head dim at C a multiple of 128 up to "
                                  f"{MAX_WIDTH}, and head dims {HEAD_DIMS} at C a multiple of 16 and of the head "
                                  f"dim up to 128 or a multiple of 128; got C={C}, heads={heads}, where the "
                                  "reference's kernel runs")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("linear attention kernel reads rows by 16-byte cp.async: q, k and v must start 16-byte "
                         f"aligned; got addresses mod 16 {[t.data_ptr() % 16 for t in (q, k, v)]}")
    out = torch.empty_like(q)
    _build.launch("catseg_linear_attention", q, k, v, out, N, S, C, heads, _EPS, int(q.dtype == torch.bfloat16))
    _build.count("linear_attention")
    return out


class _LinearAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.save_for_backward(q, k, v)
        ctx.heads = heads
        if q.is_cuda:
            return _linear_attention_cuda(q, k, v, heads)
        if q.device.type == "cpu":
            return linear_attention_plain(q, k, v, heads)
        raise RuntimeError(f"no linear attention path for device {q.device}")

    @staticmethod
    def backward(ctx, g):
        heads = ctx.heads
        return (*plain_vjp(lambda q, k, v: linear_attention_plain(q, k, v, heads), ctx.saved_tensors, g), None)


linear_attention_op = register("linear_attention", "(Tensor q, Tensor k, Tensor v, int heads) -> Tensor",
                               linear_attention_plain, _linear_attention_cuda,
                               lambda q, k, v, heads: torch.empty_like(q))


def fused_linear_attention(q, k, v, heads: int) -> torch.Tensor:
    """elu+1 kernelized attention over the class axis; q/k/v (N, S, C).
    Where no gradient is recorded, the op ``catseg_tpu_torch::linear_attention``
    (``kernels/ops.py``)."""
    if records_grad(q, k, v):
        return _LinearAttentionFn.apply(q, k, v, heads)
    return serve(linear_attention_op, "linear attention", q, k, v, heads)
